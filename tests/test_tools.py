"""End-to-end drives of the post-hoc tool CLIs on tiny trained runs.

The reference exercised visualize.py / events.py / paper_visualize.py only
by hand (SURVEY.md §3.4); these tests pin hemx's rebuild-model-from-
options.json + restore-checkpoint + render path (visualize.py:42-55
replaces the reference's meta-graph surgery, reference visualize.py:186-191)
so a refactor of model hooks or checkpoint layout can't silently break the
tooling the aux-artifact scripts drive.
"""

import os

import numpy as np
import pytest

from tests.conftest import make_args

import hemx
from hemx.data.synthetic import SyntheticDataset
from hemx.models.plugin import get_model
from hemx.parallel.mesh import make_mesh
from hemx.summaries.png import decode_png


def _train_run(run_dir, model="cnn", epochs=2, **overrides):
    overrides.setdefault("synthetic_count", 32)
    overrides.setdefault("synthetic_shape", [32, 32, 3])
    args = make_args(model=model, batch_size=2, epochs=str(epochs),
                     dir=str(run_dir), seed=11, examples=4, **overrides)
    mesh = make_mesh(0)
    splits = SyntheticDataset.get_datasets(args)
    m = get_model(model)(args, mesh)
    hemx.train(m, splits, args, mesh)
    return str(run_dir)


@pytest.fixture(scope="module")
def cnn_run(tmp_path_factory):
    return _train_run(tmp_path_factory.mktemp("cnn_run"), "cnn", epochs=2)


@pytest.fixture(scope="module")
def gan_run(tmp_path_factory):
    return _train_run(tmp_path_factory.mktemp("gan_run"), "gan", epochs=1,
                      n_disc_train=1)


def _assert_png(path):
    with open(path, "rb") as f:
        img = decode_png(f.read())
    assert img.size > 0


class TestVisualizeCli:
    def test_cnn_run_all_flag_outputs(self, cnn_run):
        """--sample/--timelapse/--activations/--weights/--loss on an
        autoencoder run: every advertised output lands in <dir>/visualize
        as a decodable PNG (or non-empty PDF)."""
        import visualize
        rc = visualize.main(["--dir", cnn_run, "--sample", "--timelapse",
                             "--activations", "--weights", "--loss"])
        assert rc == 0
        out = os.path.join(cnn_run, "visualize")
        names = sorted(os.listdir(out))
        assert "samples.png" in names
        # baseline checkpoint + one per epoch => >= 2 timelapse frames
        frames = [n for n in names if n.startswith("timelapse-")]
        assert len(frames) >= 2
        assert any(n.startswith("activations-") for n in names)
        assert any(n.startswith("weights-") for n in names)
        assert "loss.pdf" in names
        _assert_png(os.path.join(out, "samples.png"))
        _assert_png(os.path.join(out, frames[0]))
        assert os.path.getsize(os.path.join(out, "loss.pdf")) > 0

    def test_bestfit_gradient_ascent(self, cnn_run):
        """--bestfit (gradient ascent in image space, reference
        visualize.py:206-247) renders a finite montage for a chosen layer."""
        import visualize
        run = visualize.load_run(cnn_run)
        out = os.path.join(cnn_run, "visualize")
        visualize.visualize_bestfit(run, out, n_filters=2)
        fits = [n for n in os.listdir(out) if n.startswith("bestfit-")]
        assert fits
        _assert_png(os.path.join(out, fits[0]))

    def test_gan_run_samples_from_generator(self, gan_run):
        """GAN runs sample the generator (not the recon path)."""
        import visualize
        rc = visualize.main(["--dir", gan_run, "--sample"])
        assert rc == 0
        path = os.path.join(gan_run, "visualize", "samples.png")
        _assert_png(path)


class TestEventsCli:
    def test_loss_curves_pdf(self, cnn_run, tmp_path):
        import events
        out = str(tmp_path / "losses.pdf")
        assert events.main([cnn_run, "--out", out]) == 0
        assert os.path.getsize(out) > 0

    def test_tag_filter_and_logy(self, cnn_run, tmp_path):
        import events
        out = str(tmp_path / "filtered.pdf")
        assert events.main([cnn_run, "--tags", "loss", "--logy",
                            "--out", out]) == 0
        assert os.path.getsize(out) > 0

    def test_no_series_is_an_error(self, tmp_path):
        import events
        empty = tmp_path / "empty"
        (empty / "train").mkdir(parents=True)
        assert events.main([str(empty),
                            "--out", str(tmp_path / "x.pdf")]) == 1

    def test_histogram_fan(self, gan_run, tmp_path):
        """--histogram renders the percentile-fan chart for the GAN's
        sample histograms (the same summaries parity_report.py's
        sample-statistics table reads)."""
        import events
        out = str(tmp_path / "fan.png")
        rc = events.main([gan_run, "--histogram", "examples/fakes_hist",
                          "--out", out])
        assert rc == 0
        assert os.path.getsize(out) > 0

    def test_histogram_list(self, gan_run, capsys):
        import events
        assert events.main([gan_run, "--histogram", "list"]) == 0
        listed = capsys.readouterr().out
        assert "examples/fakes_hist" in listed
        assert "examples/real_hist" in listed


class TestPaperVisualizeCli:
    @pytest.fixture(scope="class")
    def standalone_run(self, tmp_path_factory):
        return _train_run(
            tmp_path_factory.mktemp("standalone_run"), "paper_standalone",
            epochs=1, synthetic_count=32, synthetic_shape=[65, 65, 3],
            g_lr=1e-3, g_beta1=0.5, g_beta2=0.999,
            model_version="mean_adjusted")

    def test_metric_chart(self, standalone_run, tmp_path):
        import paper_visualize
        out = str(tmp_path / "experiment.pdf")
        rc = paper_visualize.main([standalone_run, "--out", out,
                                   "--metrics", "linear_rmse", "t1"])
        assert rc == 0
        assert os.path.getsize(out) > 0
        tags = paper_visualize.find_metric_tags(standalone_run)
        assert "metrics_y_hat/linear_rmse" in tags
        assert "metrics_y_0/linear_rmse" in tags  # baseline predictor rows

    def test_missing_metrics_is_an_error(self, cnn_run, tmp_path):
        """A run without metric summaries (cnn) reports failure instead of
        writing an empty chart."""
        import paper_visualize
        rc = paper_visualize.main([cnn_run,
                                   "--out", str(tmp_path / "none.pdf")])
        assert rc == 1


class TestParityReportArtifacts:
    """parity_report.fid_artifact must survive the between-session wipe of
    the gitignored workspace/: fresh workspace/artifacts/fid.json wins,
    the committed artifacts/fid.json is the fallback."""

    def _load(self):
        import importlib.util
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = importlib.util.spec_from_file_location(
            "parity_report", os.path.join(root, "scripts",
                                          "parity_report.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def test_fresh_wins_tracked_falls_back(self, tmp_path, monkeypatch):
        import json
        pr = self._load()
        monkeypatch.setattr(pr, "W", str(tmp_path / "workspace" / "parity"))
        assert pr.fid_artifact() is None
        tracked = tmp_path / "artifacts"
        tracked.mkdir()
        (tracked / "fid.json").write_text(json.dumps(
            {"detail": {"fid_pixel": 0.28}}))
        detail, path = pr.fid_artifact()
        assert detail["fid_pixel"] == 0.28
        assert path.endswith(os.path.join("artifacts", "fid.json"))
        fresh = tmp_path / "workspace" / "artifacts"
        fresh.mkdir(parents=True)
        (fresh / "fid.json").write_text(json.dumps(
            {"detail": {"fid_pixel": 0.5}}))
        detail, path = pr.fid_artifact()
        assert detail["fid_pixel"] == 0.5
        assert "workspace" in path

    def test_report_refuses_to_clobber_without_runs(self, tmp_path,
                                                    monkeypatch):
        """With the session-local workspace wiped (no <model>.done), main()
        must exit 1 and leave the committed PARITY.md untouched rather
        than regenerate an all-'RUN NOT COMPLETE' report."""
        pr = self._load()
        monkeypatch.setattr(pr, "W", str(tmp_path / "workspace" / "parity"))
        out = tmp_path / "PARITY.md"
        out.write_text("committed evidence")
        monkeypatch.setattr(pr, "OUT", str(out))
        assert pr.main([]) == 1
        assert out.read_text() == "committed evidence"

    def test_report_refuses_partial_campaign(self, tmp_path, monkeypatch):
        """A PARTIALLY complete campaign (some .done markers) must also
        refuse by default (ADVICE r3: one finished run used to overwrite
        the committed report with mostly 'RUN NOT COMPLETE' rows)."""
        pr = self._load()
        w = tmp_path / "workspace" / "parity"
        (w / "cnn").mkdir(parents=True)
        (w / "cnn.done").touch()
        monkeypatch.setattr(pr, "W", str(w))
        out = tmp_path / "PARITY.md"
        out.write_text("committed evidence")
        monkeypatch.setattr(pr, "OUT", str(out))
        assert pr.main([]) == 1
        assert out.read_text() == "committed evidence"

    def test_fid_trajectory_rendering(self, tmp_path, monkeypatch):
        """When scripts/fid_trajectory.py's artifact exists, the report
        renders the FID-through-training table with floor ratios and
        provenance (VERDICT r3 missing #2)."""
        import json
        pr = self._load()
        w = tmp_path / "workspace" / "parity"
        w.mkdir(parents=True)
        monkeypatch.setattr(pr, "W", str(w))
        art = tmp_path / "workspace" / "artifacts"
        art.mkdir()
        (art / "fid_trajectory.json").write_text(json.dumps({
            "rows": [
                {"run": "iwgan@10", "epoch": 10, "fid_pixel": 1.0,
                 "fid_encoder": 300.0},
                {"run": "iwgan@100", "epoch": 100, "fid_pixel": 0.28,
                 "fid_encoder": 98.9},
                {"run": "gan@100", "epoch": "latest", "fid_pixel": 0.5,
                 "fid_encoder": 150.0},
            ],
            "fid_pixel_data_floor": 0.046,
            "fid_encoder_data_floor": 22.55,
            "samples": 4096,
            "provenance": {"measured_utc": "2026-08-19 15:00:00",
                           "argv": "scripts/fid_trajectory.py"},
        }))
        got = pr.fid_trajectory_artifact()
        assert got is not None
        traj, path = got
        assert traj["rows"][1]["fid_encoder"] == 98.9
        assert "workspace" in path
        # and the full report renders it once runs exist: fake the five
        # .done markers with empty event dirs -> rows render as incomplete
        # but the trajectory section must still appear
        for m in ("cnn", "vae", "gan", "wgan", "iwgan"):
            (w / m / "train").mkdir(parents=True)
            (w / f"{m}.done").touch()
        out = tmp_path / "PARITY.md"
        monkeypatch.setattr(pr, "OUT", str(out))
        assert pr.main([]) == 0
        text = out.read_text()
        assert "FID through training" in text
        assert "| iwgan@100 | 100 | 0.28 | 98.9 | 6.1× | 4.4× |" in text
        assert "2026-08-19 15:00:00" in text

    def test_fid_section_only_splice(self, tmp_path, monkeypatch):
        """--fid-section-only must regenerate ONLY the '## Sample quality'
        section of the committed PARITY.md (from the artifact JSONs, no
        campaign runs), leave the surrounding sections byte-identical,
        and footnote rows carried from a previous campaign's record
        (fid_trajectory.py carry-forward)."""
        import json
        pr = self._load()
        w = tmp_path / "workspace" / "parity"
        w.mkdir(parents=True)
        monkeypatch.setattr(pr, "W", str(w))
        art = tmp_path / "workspace" / "artifacts"
        art.mkdir()
        (art / "fid.json").write_text(json.dumps({"detail": {
            "fid_pixel": 0.28, "fid_pixel_data_floor": 0.046,
            "fid_encoder": 98.9, "fid_encoder_data_floor": 22.55,
            "checkpoint_dir": "workspace/parity/iwgan",
            "provenance": {"measured_utc": "2026-08-20 08:00:00",
                           "argv": "bench.py --fid"}}}))
        (art / "fid_trajectory.json").write_text(json.dumps({
            "rows": [
                {"run": "iwgan@100", "epoch": 100, "fid_pixel": 0.28,
                 "fid_encoder": 98.9},
                {"run": "iwgan@300", "epoch": 300, "fid_pixel": 0.15,
                 "fid_encoder": 45.0},
                {"run": "gan@100", "epoch": "latest", "fid_pixel": 0.85,
                 "fid_encoder": 302.9,
                 "carried_from": {"file": "artifacts/fid_trajectory.json",
                                  "measured_utc": "2026-08-19 19:30:55"}},
            ],
            "fid_pixel_data_floor": 0.046,
            "fid_encoder_data_floor": 22.55, "samples": 4096,
            "provenance": {"measured_utc": "2026-08-20 10:00:00",
                           "argv": "scripts/fid_trajectory.py"}}))
        out = tmp_path / "PARITY.md"
        out.write_text("\n".join([
            "# PARITY", "", "## Anchor rows", "", "anchor evidence", "",
            "## Sample quality (IWGAN anchor, FID)", "", "stale table",
            "", "### FID through training, across models, and under "
            "the GP ablation", "", "stale trajectory", "",
            "## Sample statistics through training (GAN family)", "",
            "stats evidence", ""]))
        monkeypatch.setattr(pr, "OUT", str(out))
        assert pr.main(["--fid-section-only"]) == 0
        text = out.read_text()
        # surrounding sections untouched
        assert "anchor evidence" in text and "stats evidence" in text
        assert text.index("anchor evidence") < text.index("Sample quality")
        # stale section gone, fresh artifact values in
        assert "stale table" not in text and "stale trajectory" not in text
        assert "| iwgan@300 | 300 | 0.15 | 45.0 |" in text
        # carried row gets the dagger + provenance footnote
        assert "| gan@100† |" in text
        assert "carried from the previous committed campaign" in text
        assert "2026-08-19 19:30:55" in text
        # extension reading renders from the fresh >100-epoch row
        assert "keeps improving" in text
        # idempotent: splicing again leaves the file unchanged
        again = out.read_text()
        assert pr.main(["--fid-section-only"]) == 0
        assert out.read_text() == again

    def test_fid_trajectory_reading_extension(self):
        """The reading paragraph pins its claims to the <=100-epoch anchor
        rows and reports the iwgan300 extension data-responsively: the
        gp_per_sample comparison must cite the epoch-100 FID even when
        later epochs exist, and the extension sentence flips between
        training-budget-limited and architecture-ceiling wording."""
        pr = self._load()
        base = [
            {"run": "iwgan@60", "epoch": 60, "fid_pixel": 0.17,
             "fid_encoder": 53.5},
            {"run": "iwgan@100", "epoch": 100, "fid_pixel": 0.28,
             "fid_encoder": 98.9},
            {"run": "iwgan_gp_per_sample@100", "epoch": "latest",
             "fid_pixel": 0.22, "fid_encoder": 69.3},
        ]
        improved = base + [{"run": "iwgan@300", "epoch": 300,
                            "fid_pixel": 0.12, "fid_encoder": 41.0}]
        text = "\n".join(pr._fid_trajectory_reading(improved))
        assert "bottoms at **53.5 (epoch 60)**" in text
        assert "final epoch 100" in text  # anchor-final, not 300
        assert "epoch-100 encoder FID 98.9" in text  # gps cites @100
        assert "keeps improving" in text and "41.0" in text
        assert "training-budget-limited" in text
        plateaued = base + [{"run": "iwgan@300", "epoch": 300,
                             "fid_pixel": 0.3, "fid_encoder": 88.0}]
        text = "\n".join(pr._fid_trajectory_reading(plateaued))
        assert "never beats that epoch-60 floor" in text
        assert "architecture itself" in text


class TestThesisFigurePresets:
    """paper_visualize --experiment 1|1b|2: the reference's reproducible
    thesis figures (reference paper_visualize.py:100-321 + its run tables
    at :339-381) rendered from the conventional --root layout that
    scripts/thesis_runs.sh trains. Tiny runs here; missing runs must be
    skipped like the reference's `if events is not None` guards."""

    @pytest.fixture(scope="class")
    def thesis_root(self, tmp_path_factory):
        root = tmp_path_factory.mktemp("thesis")
        adam = dict(g_lr=1e-3, g_beta1=0.5, g_beta2=0.999,
                    synthetic_count=32, synthetic_shape=[65, 65, 3])
        _train_run(root / "standalone" / "baseline", "paper_standalone",
                   epochs=1, model_version="baseline", **adam)
        _train_run(root / "cgan" / "baseline", "paper_cgan", epochs=1,
                   model_version="baseline", d_lr=1e-3, d_beta1=0.5,
                   d_beta2=0.999, **adam)
        _train_run(root / "sampler" / "baseline_x", "paper_sampler",
                   epochs=1, noise_layer="x", e_bn=False, d_lr=1e-3,
                   d_beta1=0.5, d_beta2=0.999, **adam)
        return str(root)

    def test_experiment1(self, thesis_root, tmp_path):
        import paper_visualize
        out = str(tmp_path / "experiment1.pdf")
        rc = paper_visualize.main(["--experiment", "1",
                                   "--root", thesis_root, "--out", out])
        assert rc == 0
        assert os.path.getsize(out) > 0

    def test_experiment1b(self, thesis_root, tmp_path):
        import paper_visualize
        out = str(tmp_path / "experiment1b.pdf")
        rc = paper_visualize.main(["--experiment", "1b",
                                   "--root", thesis_root, "--out", out])
        assert rc == 0
        assert os.path.getsize(out) > 0

    def test_experiment2(self, thesis_root, tmp_path):
        import paper_visualize
        out = str(tmp_path / "experiment2.pdf")
        rc = paper_visualize.main(["--experiment", "2",
                                   "--root", thesis_root, "--out", out])
        assert rc == 0
        assert os.path.getsize(out) > 0

    def test_empty_root_is_an_error(self, tmp_path):
        import paper_visualize
        rc = paper_visualize.main(["--experiment", "1",
                                   "--root", str(tmp_path / "nothing"),
                                   "--out", str(tmp_path / "x.pdf")])
        assert rc == 1



class TestCompileCache:
    """enable_compile_cache (called by the CLI entry points only)."""

    def test_env_var_wins(self, tmp_path, monkeypatch):
        import jax
        from hemx.utils.misc import enable_compile_cache
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_fixed_path_in_checkout(self, monkeypatch):
        import jax
        from hemx.utils.misc import enable_compile_cache
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        before = jax.config.jax_compilation_cache_dir
        try:
            path = enable_compile_cache()
            assert path == os.path.join(root, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            assert enable_compile_cache() == path  # fixed: same every call
        finally:
            jax.config.update("jax_compilation_cache_dir", before)


class TestGraftEntry:
    def test_too_few_devices_raise(self, monkeypatch):
        """No silent fallback: a dry run asking for more devices than
        exist fails (with a forced virtual CPU mesh absent)."""
        import jax
        import __graft_entry__ as ge
        monkeypatch.setenv("XLA_FLAGS", "")
        with pytest.raises(RuntimeError, match="needs"):
            ge._ensure_devices(jax.device_count() + 1)


class TestSideToolsStayOffDevices:
    def test_gui_and_events_open_no_backend(self, cnn_run, tmp_path):
        """visualize_gui.py and events.py run beside a training job, which
        holds the card: they must never initialize a JAX backend (a GPU
        backend would reserve most of the card's memory)."""
        import subprocess
        import sys
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = f"""
import os, sys
sys.path.insert(0, {root!r})
import events, visualize_gui
ws = os.path.dirname({cnn_run!r})
assert visualize_gui.main(["--list", "--workspace", ws]) == 0
visualize_gui.run_html(0, {cnn_run!r})
visualize_gui.render_scalar_png({cnn_run!r}, "train", "losses/loss")
assert events.main([{cnn_run!r}, "--out", {str(tmp_path / "l.png")!r}]) == 0
from jax._src import xla_bridge
assert not xla_bridge._backends, list(xla_bridge._backends)
print("NO_BACKEND")
"""
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=300, cwd=root)
        assert "NO_BACKEND" in r.stdout, r.stdout[-2000:] + r.stderr[-2000:]
