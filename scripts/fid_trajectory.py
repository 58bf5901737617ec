#!/usr/bin/env python
"""FID-vs-epoch trajectory + cross-model comparison (VERDICT r3 missing #2).

One process, one mesh, one pair of real/val feature sets; scores

* the IWGAN anchor every 10 epochs (its campaign run keeps every
  checkpoint),
* the GAN and WGAN anchors at their final epoch,
* the ``--gp_per_sample`` IWGAN ablation (corrected per-sample GP norm,
  hemx/ops/losses.py) at its final epoch, and
* optionally an extended-training IWGAN (epochs past 100) — together these
  show whether the headline FID is limited by the 2017 DCGAN architecture
  or by the framework.

Writes workspace/artifacts/fid_trajectory.json; parity_report renders it
into PARITY.md's Sample-quality section when present.

Usage: python scripts/fid_trajectory.py [--samples 4096]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

W = os.path.join(os.path.dirname(__file__), "..", "workspace", "parity")
OUT = os.path.join(os.path.dirname(__file__), "..", "workspace",
                   "artifacts", "fid_trajectory.json")


def main() -> int:
    global W
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--workspace", default=W,
                    help="Campaign run root (default workspace/parity).")
    ap.add_argument("--encoder_dir", default=None,
                    help="Trained cnn/vae run for the encoder extractor "
                         "(default <workspace>/cnn).")
    ap.add_argument("--epochs", type=int, nargs="*",
                    default=list(range(10, 101, 10)),
                    help="IWGAN trajectory checkpoints to score (the "
                         "campaign anchor retains every epoch; default "
                         "every 10th).")
    ap.add_argument("--out", default=OUT)
    a = ap.parse_args()
    W = a.workspace
    if a.encoder_dir is None:
        a.encoder_dir = os.path.join(W, "cnn")

    import jax
    import bench
    from hemx.data.pipeline import make_place
    from hemx.metrics.fid import encoder_features, fid_from_images
    from hemx.ops.layers import set_compute_dtype, set_deconv_impl
    from hemx.parallel.mesh import make_mesh

    # identical numerics to `bench.py --fid` (whose main() sets the bf16
    # default before run_fid): both FID producers land in the same
    # PARITY.md section and must reproduce each other
    set_compute_dtype("bfloat16")
    set_deconv_impl("dilated")
    mesh = make_mesh(0)

    # one shared real/val feature base (all campaign runs share the same
    # synthetic dataset + seed, so the floors are common)
    enc_model, enc_ts, _, _ = bench._load_run(a.encoder_dir, mesh)
    ext = encoder_features(enc_model, enc_ts)

    reals = vals = None
    rows = []

    # Carry-forward base: the tracked artifact from the last committed
    # campaign. workspace/ is wiped between sessions, so a session that
    # retrains only a SUBSET of the campaign (e.g. the iwgan anchor plus
    # its 300-epoch extension) would otherwise silently drop the
    # committed gan/wgan/ablation rows on regeneration. Rows whose run is
    # absent this session are carried verbatim, each stamped with
    # ``carried_from`` (source file + its measured_utc) so every row's
    # provenance is self-describing — round 4 showed the campaign recipe
    # reproduces FID across sessions to four digits, so carried rows are
    # re-derivable constants, not stale estimates.
    tracked_path = os.path.join(os.path.dirname(__file__), "..",
                                "artifacts", "fid_trajectory.json")
    carried_rows: dict = {}
    carried_meta: dict = {}
    try:
        with open(tracked_path) as f:
            _t = json.load(f)
        carried_rows = {r["run"]: r for r in _t.get("rows", [])}
        carried_meta = {
            "file": os.path.relpath(tracked_path),
            "measured_utc": _t.get("provenance", {}).get("measured_utc"),
            "floors": {k: _t.get(k) for k in ("fid_pixel_data_floor",
                                              "fid_encoder_data_floor")},
        }
    except (OSError, ValueError, KeyError):
        pass

    def carry(label) -> bool:
        row = carried_rows.get(label)
        if row is None:
            return False
        row = {k: v for k, v in row.items() if k != "carried_from"}
        row["carried_from"] = {"file": carried_meta["file"],
                               "measured_utc": carried_meta["measured_utc"]}
        rows.append(row)
        print(f"carry {label} from {carried_meta['file']}", flush=True)
        return True

    def score(run_dir, epoch, label):
        nonlocal reals, vals
        if not os.path.isdir(run_dir):
            if not carry(label):
                print(f"skip {label}: no run at {run_dir}")
            return
        if epoch is not None and not os.path.exists(
                os.path.join(run_dir, f"checkpoint-{epoch}.npz")):
            if not carry(label):
                print(f"skip {label}: no checkpoint-{epoch}")
            return
        model, ts, splits, margs = bench._load_run(run_dir, mesh,
                                                   epoch=epoch)
        gb = margs.batch_size * mesh.devices.size
        if reals is None:
            place = make_place(mesh, splits["train"], keys=("image",))
            reals = bench.collect_real_images(splits["train"], place, gb,
                                              a.samples)
            vals = bench.collect_real_images(
                splits.get("validate", splits["train"]), place, gb,
                a.samples)
        fakes = bench.sample_fakes(model, ts, gb, a.samples)
        row = {
            "run": label, "dir": os.path.relpath(run_dir),
            "epoch": epoch if epoch is not None else "latest",
            "fid_pixel": round(fid_from_images(reals, fakes), 4),
            "fid_encoder": round(fid_from_images(reals, fakes, ext), 4),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    # trajectory over the IWGAN anchor's retained checkpoints
    iwgan = os.path.join(W, "iwgan")
    for ep in a.epochs:
        score(iwgan, ep, f"iwgan@{ep}")
    # extended-training run (campaign's iwgan300): fixed waypoints plus
    # the latest retained checkpoint past 100 — the run may still be
    # mid-flight when pass 1 scores it
    iwgan300 = os.path.join(W, "iwgan300")
    eps = {150, 200, 300}
    if os.path.isdir(iwgan300):
        from hemx.train.checkpoint import CheckpointManager
        have = [e for e, _ in CheckpointManager(iwgan300).checkpoints()]
        latest = max((e for e in have if e > 100), default=None)
        if latest is not None:
            eps.add(latest)
        eps = sorted(e for e in eps if e in have)
    else:
        eps = []
    for ep in eps:
        score(iwgan300, ep, f"iwgan@{ep}")
    # cross-model at final epoch
    score(os.path.join(W, "gan"), None, "gan@100")
    score(os.path.join(W, "wgan"), None, "wgan@100")
    # ablation: corrected per-sample GP norm
    score(os.path.join(W, "iwgan_gps"), None, "iwgan_gp_per_sample@100")

    if not rows:
        print("no runs scored", file=sys.stderr)
        return 1
    if reals is None:
        # every row was carried — nothing fresh to compute floors from;
        # keep the carried campaign's floors (same dataset recipe + seed)
        floors = carried_meta.get("floors", {})
    else:
        floors = {
            "fid_pixel_data_floor": round(fid_from_images(reals, vals), 4),
            "fid_encoder_data_floor": round(fid_from_images(reals, vals,
                                                            ext), 4),
        }
    result = {
        "rows": rows, **floors, "samples": a.samples,
        "encoder_dir": os.path.relpath(a.encoder_dir),
        "provenance": {
            "measured_utc": time.strftime("%Y-%m-%d %H:%M:%S",
                                          time.gmtime()),
            "argv": " ".join(sys.argv),
        },
    }
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    out = a.out
    if len(rows) < len(carried_rows):
        # fewer rows than the committed record can only mean scoring broke
        # mid-run (a carried row exists for every label we fail to score):
        # park the partial result instead of letting the chain's mirror
        # replace the tracked artifact with a lossy one
        out = a.out + ".partial"
        print(f"PARTIAL: {len(rows)} rows < tracked {len(carried_rows)} — "
              f"writing {out} and leaving {a.out} untouched",
              file=sys.stderr)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"wrote {out} ({len(rows)} rows)")
    return 0 if out == a.out else 1


if __name__ == "__main__":
    sys.exit(main())
