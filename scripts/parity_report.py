#!/usr/bin/env python
"""Generate PARITY.md from the parity-campaign runs (VERDICT r1 #1).

Reads the five anchor runs under workspace/parity/, extracts loss
trajectories from their tfevents, computes data-derived baselines that
calibrate the synthetic-dataset numbers, and writes the reference
examples.org rows beside the hemx rows.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from hemx.summaries.reader import get_histogram_values, get_tag_values

W = os.path.join(os.path.dirname(__file__), "..", "workspace", "parity")
OUT = os.path.join(os.path.dirname(__file__), "..", "PARITY.md")

# examples.org rows (reference: /root/reference/examples/examples.org)
REF = {
    "cnn":   dict(final="L1 0.1273", secs=5238, steps=30858),
    "vae":   dict(final="total 935,635.7", secs=5582, steps=30971),
    "gan":   dict(final="g 17.73 / d 0.0000", secs=33338, steps=61533),
    "wgan":  dict(final="g 7,613.1 / d -15,768.2", secs=26481, steps=37052),
    "iwgan": dict(final="(losses not recorded)", secs=37246, steps=36904),
}
LOSS_TAGS = {
    "cnn": ["loss"],
    "vae": ["total_loss", "d_loss", "l_loss"],
    "gan": ["g_loss", "d_loss"],
    "wgan": ["g_loss", "d_loss"],
    "iwgan": ["g_loss", "d_loss"],
}


_EVENTS_CACHE: dict = {}


def series(model, tag, phase="train"):
    # one full event-file parse per (model, phase) — the reader's events=
    # parameter serves every tag from it (a VAE row reads 3 tags x 2 phases)
    logdir = os.path.join(W, model, phase)
    if logdir not in _EVENTS_CACHE:
        from hemx.summaries.reader import get_all_events
        _EVENTS_CACHE[logdir] = get_all_events(logdir)
    return get_tag_values(logdir, f"losses/{tag}",
                          events=_EVENTS_CACHE[logdir])


def fmt(v):
    if abs(v) >= 10000:
        return f"{v:,.1f}"
    return f"{v:.4g}"


def elapsed_seconds(model, max_gap: float = 600.0, base: str | None = None):
    """(seconds, had_pauses: bool): actual training wall-clock measured as
    the sum of consecutive event wall-time deltas across ALL the run's
    tfevents files, dropping pauses (crash-restart recompiles,
    between-session idle). This survives campaign restarts, which truncate
    the text log (the naive 'Elapsed time:' line then only covers the
    final attempt).

    A span counts as a pause only when it is BOTH >= ``max_gap`` and >=
    10x the run's median inter-event delta: a fixed threshold alone would
    silently drop legitimate slow spans (a >10-min initial jit compile, an
    epoch slower than ~30 min at the 3-summaries/epoch cadence) and
    understate training time, flattering the speedup column."""
    from hemx.summaries.reader import get_all_events
    times: list[float] = []
    for phase in ("train", "validate"):
        for rows in get_all_events(
                os.path.join(base or W, model, phase)).values():
            times.extend(w for w, _, _ in rows)
    if len(times) < 2:
        return None, False
    times = sorted(set(times))
    deltas = np.diff(times)
    gap = max(max_gap, 10.0 * float(np.median(deltas)))
    total = float(deltas[deltas < gap].sum())
    return int(total), bool((deltas >= gap).any())


def fid_artifact() -> tuple[dict, str] | None:
    """(detail dict, source path) of fid.json (bench.py --fid output): the
    fresh workspace/artifacts/ copy if bench.py --fid ran in this
    checkout, else a committed artifacts/ copy (workspace/ is not kept);
    None when neither exists. The source path + the detail's provenance
    are RENDERED into PARITY.md so a stale artifact attributed to a newer
    campaign is self-describing (ADVICE r3)."""
    # normpath: with workspace/parity wiped (the exact scenario the
    # fallback exists for), a raw ..-relative open() fails ENOENT on the
    # missing intermediate dirs before ever reaching artifacts/.
    for base in (os.path.normpath(os.path.join(W, "..", "artifacts")),
                 os.path.normpath(os.path.join(W, "..", "..",
                                               "artifacts"))):
        path = os.path.join(base, "fid.json")
        try:
            with open(path) as f:
                return json.load(f)["detail"], path
        except (OSError, ValueError, KeyError):
            pass
    return None


def fid_trajectory_artifact() -> tuple[dict, str] | None:
    """(content, source path) of scripts/fid_trajectory.py's output —
    fresh workspace/artifacts/ copy first, committed artifacts/ fallback
    (same discipline as fid_artifact)."""
    for base in (os.path.normpath(os.path.join(W, "..", "artifacts")),
                 os.path.normpath(os.path.join(W, "..", "..",
                                               "artifacts"))):
        path = os.path.join(base, "fid_trajectory.json")
        try:
            with open(path) as f:
                return json.load(f), path
        except (OSError, ValueError):
            pass
    return None


def _fid_trajectory_reading(rows: list[dict]) -> list[str]:
    """One data-driven paragraph under the trajectory table: where the
    IWGAN anchor's encoder FID bottoms, how the other 2017 architectures
    compare at their final epoch, and what the corrected per-sample GP
    norm buys — the evidence that the FID level is set by the reference's
    DCGAN-2017 architecture + schedule, not by the framework."""
    iwgan = [r for r in rows if r["run"].startswith("iwgan@")
             and isinstance(r["epoch"], int)]
    anchor = [r for r in iwgan if r["epoch"] <= 100]
    if not anchor:
        return []
    best = min(anchor, key=lambda r: r["fid_encoder"])
    final = max(anchor, key=lambda r: r["epoch"])
    by_run = {r["run"]: r for r in rows}
    out = [
        "",
        f"Reading: the IWGAN anchor's encoder FID bottoms at "
        f"**{best['fid_encoder']:.1f} (epoch {best['epoch']})** and then "
        f"oscillates ({final['fid_encoder']:.1f} at its final epoch "
        f"{final['epoch']}) — adversarial training does not converge "
        f"monotonically, so the headline epoch-100 number is a schedule "
        f"artifact of the reference's fixed 100-epoch recipe, not the "
        f"run's best.",
    ]
    ext = [r for r in iwgan if r["epoch"] > 100]
    if ext:
        ebest = min(ext, key=lambda r: r["fid_encoder"])
        if ebest["fid_encoder"] < best["fid_encoder"]:
            verb = (f"keeps improving — to "
                    f"**{ebest['fid_encoder']:.1f} (epoch "
                    f"{ebest['epoch']})** — so the epoch-100 level is "
                    f"training-budget-limited, not a ceiling of the "
                    f"architecture")
        else:
            verb = (f"never beats that epoch-{best['epoch']} floor (best "
                    f"{ebest['fid_encoder']:.1f} at epoch "
                    f"{ebest['epoch']}): more of the reference's own "
                    f"schedule cannot buy a better sample, placing the "
                    f"ceiling in the 2017 DCGAN architecture itself")
        out.append(
            f"Extending the same run to epoch "
            f"{max(r['epoch'] for r in ext)} shows the FID {verb}.")
    gan, wgan = by_run.get("gan@100"), by_run.get("wgan@100")
    if gan and wgan:
        out.append(
            f"The other two 2017-era anchors sit far above it at their "
            f"own final epochs (gan {gan['fid_encoder']:.1f}, wgan "
            f"{wgan['fid_encoder']:.1f}): the gradient-penalty IWGAN is "
            f"the best of the reference's architectures under this "
            f"framework, matching the reference's own qualitative "
            f"ranking (examples.org).")
    gps = by_run.get("iwgan_gp_per_sample@100")
    if gps:
        out.append(
            f"Correcting the reference's whole-batch GP norm to the "
            f"paper's per-sample norm (`--gp_per_sample`) improves the "
            f"epoch-100 encoder FID {final['fid_encoder']:.1f} → "
            f"**{gps['fid_encoder']:.1f}** with no framework change — "
            f"together these bound the residual above the data floor as "
            f"architecture/recipe-limited, not framework-limited.")
    return out


def _hist_moments(h: dict):
    """(mean, std) from a HistogramProto's exact sum / sum_squares."""
    n = h.get("num") or 0
    if not n:
        return None, None
    mean = h["sum"] / n
    var = max(h["sum_squares"] / n - mean * mean, 0.0)
    return mean, var ** 0.5


def _hist_tvd(a: dict, b: dict) -> float | None:
    """Total-variation distance between two bucketed histograms. Both use
    the same TF exponential edge table, so buckets align by their limit."""
    def masses(h):
        total = sum(h.get("bucket", [])) or 1.0
        return {lim: c / total for lim, c in
                zip(h.get("bucket_limit", []), h.get("bucket", []))}
    ma, mb = masses(a), masses(b)
    if not ma or not mb:
        return None
    return 0.5 * sum(abs(ma.get(k, 0.0) - mb.get(k, 0.0))
                     for k in set(ma) | set(mb))


def sample_statistics(model: str, target_epochs=(10, 50, 100),
                      calls_per_epoch: int = 32, base: str | None = None):
    """Generated-sample statistics vs data at checkpoints through training
    (BASELINE.md 'sample-statistics parity'), derived from the
    examples/fakes_hist + examples/real_hist summaries write_summaries
    records — the GAN-family step counter is one per train() call, so
    epoch E ends at step E*calls_per_epoch (16,384 imgs / 512 batch).

    Returns rows of (epoch, fake_mean, fake_std, real_mean, real_std, tvd).
    """
    logdir = os.path.join(base or W, model, "train")
    # dict() dedupes steps that were re-written across a crash-restart,
    # keeping the LAST (post-resume) occurrence for fakes AND reals — so a
    # row never pairs a pre-crash fake histogram with a post-resume real one
    fakes = list(dict(get_histogram_values(logdir,
                                           "examples/fakes_hist")).items())
    reals = dict(get_histogram_values(logdir, "examples/real_hist"))
    if not fakes:
        return []
    rows = []
    for ep in target_epochs:
        target = ep * calls_per_epoch
        step, fh = min(fakes, key=lambda r: abs(r[0] - target))
        if abs(step - target) > calls_per_epoch:  # run didn't reach epoch
            continue
        rh = reals.get(step)
        fm, fs = _hist_moments(fh)
        rm, rs = _hist_moments(rh) if rh else (None, None)
        tvd = _hist_tvd(fh, rh) if rh else None
        rows.append(dict(epoch=ep, step=step, fake_mean=fm, fake_std=fs,
                         real_mean=rm, real_std=rs, tvd=tvd))
    return rows


def data_baselines():
    """L1/recon baselines of the synthetic distribution itself, so the
    absolute hemx numbers are interpretable: an AE that only learned the
    dataset mean would score `mean_l1`; one that memorized everything
    would approach 0."""
    from hemx.data.synthetic import _make_images
    imgs = _make_images(2048, 64, 64, 3, seed=7)   # campaign seed
    x = 2.0 * (imgs - 0.5)
    mean_img = x.mean(axis=0, keepdims=True)
    mean_l1 = float(np.abs(x - mean_img).mean())
    # channel-mean predictor (best per-pixel constant-per-image guess)
    per_image_mean = x.mean(axis=(1, 2, 3), keepdims=True)
    pim_l1 = float(np.abs(x - per_image_mean).mean())
    return {"mean_image_l1": mean_l1, "per_image_mean_l1": pim_l1}


def sample_quality_lines() -> list[str]:
    """The '## Sample quality' section (headline FID table + the FID
    trajectory/cross-model/ablation subsection), generated purely from
    the measured artifact JSONs (fid.json / fid_trajectory.json, fresh
    copy first, tracked fallback) — no campaign run dirs needed."""
    lines: list[str] = []
    fid_src = fid_artifact()
    if fid_src:
        fid, fid_path = fid_src
        prov = fid.get("provenance")
        if isinstance(prov, dict):
            prov = (f"measured {prov.get('measured_utc', '?')} UTC by "
                    f"`{prov.get('argv', 'bench.py --fid')}`")
        rel = os.path.relpath(fid_path, os.path.join(W, "..", ".."))
        lines += [
            "",
            "## Sample quality (IWGAN anchor, FID)",
            "",
            "The reference published no FID (SURVEY.md §6); the data-vs-data",
            "floor calibrates the scale (computed by `bench.py --fid` over",
            f"the trained parity IWGAN; source `{rel}`"
            + (f", {prov}" if prov else "")
            + f", scored checkpoints `{fid.get('checkpoint_dir', '?')}`):",
            "",
            "| extractor | FID(generated, train) | FID(val, train) floor |",
            "|---|---|---|",
            f"| pixel 8×8 | {fid.get('fid_pixel', '—')} | "
            f"{fid.get('fid_pixel_data_floor', '—')} |",
        ]
        if "fid_encoder" in fid:
            lines.append(
                f"| trained cnn encoder | {fid['fid_encoder']} | "
                f"{fid.get('fid_encoder_data_floor', '—')} |")
        try:
            rp = fid["fid_pixel"] / fid["fid_pixel_data_floor"]
            re_ = fid["fid_encoder"] / fid["fid_encoder_data_floor"]
            lines += [
                "",
                f"Generated-vs-floor ratio: {rp:.1f}× (pixel), "
                f"{re_:.1f}× (encoder) — generated samples sit measurably",
                "farther from the train split than the val split does, as",
                "expected for a 100-epoch small GAN; the floor calibrates",
                "each extractor's scale.",
            ]
        except (KeyError, ZeroDivisionError, TypeError):
            pass

    traj_src = fid_trajectory_artifact()
    if traj_src:
        traj, traj_path = traj_src
        prov = traj.get("provenance", {})
        rel = os.path.relpath(traj_path, os.path.join(W, "..", ".."))
        pf = traj.get("fid_pixel_data_floor")
        ef = traj.get("fid_encoder_data_floor")
        lines += [
            "",
            "### FID through training, across models, and under "
            "the GP ablation",
            "",
            f"(source `{rel}`, measured {prov.get('measured_utc', '?')} UTC",
            f"by `{prov.get('argv', 'scripts/fid_trajectory.py')}`;",
            f"data-vs-data floors: pixel {pf}, encoder {ef};",
            f"{traj.get('samples', '?')} samples/row, shared extractors)",
            "",
            "| run | epoch | FID pixel | FID encoder | pixel/floor | encoder/floor |",
            "|---|---|---|---|---|---|",
        ]
        carried = False
        for r in traj.get("rows", []):
            rp = (f"{r['fid_pixel']/pf:.1f}×" if pf else "—")
            re_ = (f"{r['fid_encoder']/ef:.1f}×" if ef else "—")
            mark = ""
            if r.get("carried_from"):
                mark, carried = "†", True
            lines.append(f"| {r['run']}{mark} | {r['epoch']} | "
                         f"{r['fid_pixel']} | {r['fid_encoder']} | {rp} "
                         f"| {re_} |")
        if carried:
            srcs = sorted({f"`{r['carried_from']['file']}` (measured "
                           f"{r['carried_from'].get('measured_utc', '?')} "
                           f"UTC)"
                           for r in traj.get("rows", [])
                           if r.get("carried_from")})
            lines += [
                "",
                "† carried from the previous committed campaign's record — "
                + ", ".join(srcs)
                + " — because this session retrained only a subset of the "
                  "runs; the campaign recipe reproduces FID across "
                  "sessions to four digits (round-4 determinism check, "
                  "PERF.md 'Sample quality').",
            ]
        lines += _fid_trajectory_reading(traj.get("rows", []))
    return lines


def splice_fid_section() -> int:
    """--fid-section-only: regenerate ONLY the '## Sample quality' section
    of the committed PARITY.md in place (everything from that header up to
    the next '## ' header), leaving the anchor/trajectory/statistics
    evidence untouched. For sessions that refreshed the FID artifacts
    (e.g. the iwgan300 extension) without retraining all five anchors —
    the full regeneration path refuses to run then, by design."""
    new = sample_quality_lines()
    if not new:
        print("no fid/fid_trajectory artifacts to render", file=sys.stderr)
        return 1
    with open(OUT) as f:
        old = f.read().splitlines()
    try:
        start = old.index("## Sample quality (IWGAN anchor, FID)")
    except ValueError:
        print(f"no '## Sample quality' section in {OUT}", file=sys.stderr)
        return 1
    end = next((i for i in range(start + 1, len(old))
                if old[i].startswith("## ")), len(old))
    # sample_quality_lines() starts with a "" separator; the text above
    # the old header already ends with one
    spliced = old[:start] + new[1:] + [""] + old[end:]
    with open(OUT, "w") as f:
        f.write("\n".join(spliced) + "\n")
    print(f"spliced Sample-quality section into {OUT}")
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--allow-partial", action="store_true",
                    help="Regenerate PARITY.md even when some anchors "
                         "have no .done marker (mid-campaign use); the "
                         "default refuses so a partial campaign can't "
                         "clobber committed evidence with 'RUN NOT "
                         "COMPLETE' rows (ADVICE r3).")
    ap.add_argument("--fid-section-only", action="store_true",
                    help="Splice a regenerated '## Sample quality' "
                         "section into the committed PARITY.md from the "
                         "fid/fid_trajectory artifacts, leaving every "
                         "other section untouched (no campaign runs "
                         "needed).")
    opts = ap.parse_args(argv)
    if opts.fid_section_only:
        return splice_fid_section()

    rows = []
    for model in ("cnn", "vae", "gan", "wgan", "iwgan"):
        if not os.path.exists(os.path.join(W, f"{model}.done")):
            rows.append((model, None))
            continue
        tags = LOSS_TAGS[model]
        el, el_est = elapsed_seconds(model)
        info = {"elapsed_s": el, "elapsed_estimated": el_est}
        for t in tags:
            tr = series(model, t)
            va = series(model, t, "validate")
            if tr:
                info[t] = dict(first=tr[0][1], last=tr[-1][1],
                               steps=tr[-1][0],
                               val_last=(va[-1][1] if va else None))
        rows.append((model, info))

    missing = [m for m, info in rows if info is None]
    if missing and not opts.allow_partial:
        # some (or all) anchors not trained in this session's workspace
        # (it is gitignored and wiped between sessions) -- refuse to
        # clobber the committed campaign evidence with "RUN NOT COMPLETE"
        # rows; pass --allow-partial for deliberate mid-campaign reports
        print("missing parity runs under", os.path.normpath(W), ":",
              ", ".join(missing),
              "-- leaving the committed PARITY.md untouched "
              "(train each anchor into workspace/parity/<model> and "
              "touch <model>.done first, or pass --allow-partial)",
              file=sys.stderr)
        return 1

    base = data_baselines()
    ts = time.strftime("%Y-%m-%d %H:%M UTC", time.gmtime())

    lines = [
        "# PARITY — hemx vs reference `examples.org` anchors",
        "",
        f"Generated {ts} by `scripts/parity_report.py` from the",
        "parity-campaign runs: the five reference anchor configs",
        "trained for the full **100 epochs** at the reference's exact",
        "hyperparameters (global batch 512, optimizer/lr/betas per row,",
        "n_critic=5 for WGAN/IWGAN) on one device.",
        "",
        "**Dataset caveat (and why it is unavoidable):** the reference rows",
        "were trained on its private `floorplans` set, which has no public",
        "download — the reference itself reads it from local file lists",
        "(`hem/data/floorplan.py`), and this environment has zero egress, so",
        "neither floorplans nor CIFAR can be fetched. The campaign therefore",
        "runs on hemx's structured synthetic distribution (16,384 train",
        "images, 64×64×3, uint8-shipped: linear-gradient background + 5",
        "soft elliptical blobs, ~52 dof/image — a genuinely learnable",
        "low-dimensional manifold). Absolute loss values are dataset",
        "properties; what IS comparable — and what this file demonstrates —",
        "is (a) convergence/stability over 100 epochs at reference",
        "hyperparameters, (b) loss *semantics* and scale (identical",
        "reductions, e.g. the VAE's sum-reduction), (c) GAN loss-balance",
        "dynamics, and (d) wall-clock per 100 epochs vs the 2-GPU record.",
        "",
        "## Anchor rows",
        "",
        "(hemx elapsed = summed wall-time of the run's training events;",
        "`~` marks a run with crash-restart/resume pauses dropped from the",
        "sum — its active training time, excluding idle gaps.)",
        "",
        "| model | reference (2 GPUs, floorplans, 100 ep) | hemx (1 device, synthetic, 100 ep) | hemx elapsed / ref elapsed |",
        "|---|---|---|---|",
    ]
    for model, info in rows:
        ref = REF[model]
        if info is None:
            lines.append(f"| {model} | {ref['final']}; {ref['secs']:,} s | "
                         f"RUN NOT COMPLETE | — |")
            continue
        parts = []
        for t in LOSS_TAGS[model]:
            if t in info:
                parts.append(f"{t} {fmt(info[t]['last'])}")
        el = info.get("elapsed_s")
        approx = "~" if info.get("elapsed_estimated") else ""
        speed = (f"{approx}{el:,} s / {ref['secs']:,} s = "
                 f"{approx}{el/ref['secs']:.2f}x" if el else "—")
        lines.append(f"| {model} | {ref['final']}; {ref['secs']:,} s "
                     f"({ref['steps']:,} steps) | {'; '.join(parts)} | {speed} |")

    lines += [
        "",
        "## Trajectories (first → last train loss, with validation)",
        "",
        "| model | loss | first | final (train) | final (validate) |",
        "|---|---|---|---|---|",
    ]
    for model, info in rows:
        if not info:
            continue
        for t in LOSS_TAGS[model]:
            if t not in info:
                continue
            i = info[t]
            val = fmt(i["val_last"]) if i["val_last"] is not None else "—"
            lines.append(f"| {model} | {t} | {fmt(i['first'])} | "
                         f"{fmt(i['last'])} | {val} |")

    lines += [
        "",
        "## Calibration baselines (synthetic distribution, [-1,1] space)",
        "",
        f"- L1 against the dataset **mean image**: {base['mean_image_l1']:.4f}",
        f"- L1 against each image's **own mean**: {base['per_image_mean_l1']:.4f}",
        "",
        "An autoencoder that only learned the dataset mean would plateau at",
        "the first number; landing well below both demonstrates real",
        "reconstruction. (The reference's absolute 0.1273 is a floorplans",
        "property — near-binary line drawings — and is not comparable",
        "across datasets; the comparison that matters is converged-vs-",
        "baseline on each side.)",
    ]

    lines += sample_quality_lines()

    stat_rows = [(m, sample_statistics(m)) for m in ("gan", "wgan", "iwgan")]
    if any(r for _, r in stat_rows):
        lines += [
            "",
            "## Sample statistics through training (GAN family)",
            "",
            "Generated-sample pixel mean/std and bucketed-histogram total-",
            "variation distance vs the real batch at the SAME summary step",
            "(BASELINE.md 'sample-statistics parity'; derived from the",
            "`examples/fakes_hist` / `examples/real_hist` summaries — real",
            "rows are the data's own statistics, the convergence target):",
            "",
            "| model | epoch | fake mean | fake std | real mean | real std | hist TVD |",
            "|---|---|---|---|---|---|---|",
        ]
        for model, rows_ in stat_rows:
            for r in rows_:
                f = lambda v: "—" if v is None else f"{v:.4f}"
                lines.append(
                    f"| {model} | {r['epoch']} | {f(r['fake_mean'])} | "
                    f"{f(r['fake_std'])} | {f(r['real_mean'])} | "
                    f"{f(r['real_std'])} | {f(r['tvd'])} |")

    lines += [
        "",
        "## Optimizer-parity note",
        "",
        "This campaign ran under the round-3 TF-parity rmsprop (optax",
        "configured to match tf.train.RMSPropOptimizer: ones-initialized",
        "mean-square accumulator via initial_scale=1.0, eps 1e-10 —",
        "hemx/train/optimizers.py), so the rmsprop anchors",
        "(cnn/vae/gan/wgan) follow the reference's exact update rule from",
        "step 0; the iwgan anchor (adam) was always exact.",
        "",
        "## Semantics checks reproduced from the reference",
        "",
        "- **VAE loss scale**: sum-reduced Bernoulli recon + KL",
        "  (models/vae.py:75-83) — hemx's ~1e6-scale total_loss at global",
        "  batch 512 matches the reference's accounting (935k at its data).",
        "- **WGAN**: critic loss negative and bounded under ±0.01 clipping;",
        "  n_critic=5 fresh batches per generator step (models/gan.py:134-155).",
        "- **IWGAN**: GP λ=10 with the reference's whole-batch norm quirk;",
        "  adam(1e-4, 0.5, 0.9) exactly as examples.org.",
        "- **Step accounting**: hemx's ``step`` increments once per train()",
        "  call (v2 semantics, one-train-call steps — hemx/models/gan.py:282",
        "  keeps step constant across critic substeps); the reference's GAN row",
        "  counts G+D applies, which is why its step totals differ from its",
        "  epoch×batches product.",
        "",
        "Raw event files land under the session-local (gitignored)",
        "`workspace/parity/<model>/`; this committed report is the durable",
        "record (regenerate: train each anchor with `train.py` into",
        "`workspace/parity/<model>`, touch `<model>.done`, then run this",
        "script).",
    ]
    with open(OUT, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
