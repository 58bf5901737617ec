"""bench.py unit coverage that needs no device benchmark: the e2e and
compute runners at tiny sizes on the CPU mesh, baseline flagging, and the
one-line stdout contract."""

import json

import pytest

import bench


class TestRunCompute:
    def test_result_names_its_device(self):
        """Every timing names the device it ran on, so a CPU run's numbers
        can never pass for device metrics."""
        import types
        import jax
        args = types.SimpleNamespace(batch=8, image=16, latent=8, steps=1,
                                     warmup=1, no_fused=False)
        d = bench.run_compute(args)["detail"]
        assert d["platform"] == "cpu" == jax.devices()[0].platform
        assert d["device_kind"] == jax.devices()[0].device_kind
        assert d["n_chips"] == jax.device_count()
        assert d["step_time_s"] > 0


class TestRunE2E:
    """Drive the full --e2e path (TFRecord write -> parse -> uint8 H2D ->
    on-chip normalize -> train step -> epoch timing) on the 8-device CPU
    mesh at tiny sizes, for both workloads."""

    def _args(self, tmp_path, model, device_cache=False):
        import types
        return types.SimpleNamespace(
            batch=16, image=32, latent=16, steps=2, warmup=1, no_fused=False,
            e2e_count=96, e2e_epochs=3, cache=str(tmp_path), model=model,
            device_cache=device_cache, device_cache_mb=1024)

    def _check(self, result, model, expect_ref):
        assert result["unit"] == "images/sec/chip"
        assert model.upper() in result["metric"]
        d = result["detail"]
        assert d["steady_statistic"] == "median"
        assert len(d["steady_epochs_all_s"]) == 2
        assert d["first_epoch_s"] > 0 and d["steady_epoch_s"] > 0
        assert d["reference_images_per_sec_2gpu"] == round(expect_ref, 2)
        # non-default --batch/--image: ratio must be flagged not reported
        assert result["vs_baseline"] is None
        assert "not comparable" in result["vs_baseline_note"]

    def test_cnn_pipeline(self, tmp_path):
        args = self._args(tmp_path, "cnn")
        result = bench.run_e2e(args)
        assert result["detail"]["calls_per_epoch"] == 6  # 96/16 batches
        self._check(result, "cnn", bench.REF_CNN_IMG_PER_SEC)

    def test_iwgan_pipeline(self, tmp_path):
        args = self._args(tmp_path, "iwgan")
        result = bench.run_e2e(args)
        assert result["detail"]["calls_per_epoch"] == 1  # 6 batches/call
        self._check(result, "iwgan", bench.REF_IWGAN_IMG_PER_SEC)

    def test_cnn_device_cache(self, tmp_path):
        args = self._args(tmp_path, "cnn", device_cache=True)
        result = bench.run_e2e(args)
        assert "device-resident cache" in result["metric"]
        self._check(result, "cnn", bench.REF_CNN_IMG_PER_SEC)

    def test_device_cache_over_budget_is_diagnostic(self, tmp_path):
        """An over-budget dataset must exit with the actionable message,
        not crash later on a None pipeline (python -O stripped the old
        assert entirely)."""
        import pytest
        args = self._args(tmp_path, "cnn", device_cache=True)
        args.device_cache_mb = 0
        with pytest.raises(SystemExit, match="device_cache_mb"):
            bench.run_e2e(args)


class TestBaselineFlagging:
    """vs_baseline must only be reported at each workload's OWN reference
    config: IWGAN's record is bs512/64px, the CNN transcript's is
    bs1024/64px (model-aware since round 3; ADVICE r2)."""

    def _result(self):
        return {"vs_baseline": 1.5}

    def _args(self, batch, image):
        import types
        return types.SimpleNamespace(batch=batch, image=image)

    def test_iwgan_baseline_config_keeps_ratio(self):
        r = self._result()
        bench._flag_nonbaseline_config(r, self._args(512, 64), "iwgan")
        assert r["vs_baseline"] == 1.5 and "vs_baseline_note" not in r

    def test_cnn_baseline_is_bs1024(self):
        r = self._result()
        bench._flag_nonbaseline_config(r, self._args(1024, 64), "cnn")
        assert r["vs_baseline"] == 1.5 and "vs_baseline_note" not in r

    def test_cnn_at_bs512_is_flagged(self):
        # the exact apples-to-oranges case: hemx CNN at bs512 vs the
        # reference's bs1024 record
        r = self._result()
        bench._flag_nonbaseline_config(r, self._args(512, 64), "cnn")
        assert r["vs_baseline"] is None
        assert "bs1024" in r["vs_baseline_note"]

    def test_iwgan_offsize_is_flagged(self):
        r = self._result()
        bench._flag_nonbaseline_config(r, self._args(256, 64), "iwgan")
        assert r["vs_baseline"] is None
        assert "bs512" in r["vs_baseline_note"]


class TestStdoutContract:
    """stdout is ONE short json.loads-able line whatever the detail holds:
    a reader of the output's tail must be able to parse it. The full result
    lands in the detail file."""

    @pytest.fixture(autouse=True)
    def _restore_layer_policy(self):
        """bench.main sets the process-wide compute dtype (bfloat16 by
        default); later tests in this process expect float32."""
        from hemx.ops.layers import set_compute_dtype, set_deconv_impl
        yield
        set_compute_dtype(None)
        set_deconv_impl("dilated")

    def _fake_result(self):
        return {"metric": "IWGAN train images/sec/chip (bs512)",
                "value": 1178.0, "unit": "images/sec/chip",
                "vs_baseline": 2.322,
                "detail": {"step_time_s": 0.4346, "n_chips": 1,
                           "platform": "gpu", "device_kind": "H100",
                           "pad": "x" * 4000}}

    def test_one_short_parseable_line(self, tmp_path, monkeypatch, capsys):
        import sys
        fake_file = tmp_path / "bench.py"
        fake_file.write_text("")
        monkeypatch.setattr(bench, "__file__", str(fake_file))
        monkeypatch.setattr(bench, "run_compute",
                            lambda args: self._fake_result())
        # the CLI's compile-cache setup must not touch this process's config
        monkeypatch.setattr("hemx.utils.misc.enable_compile_cache",
                            lambda: None)
        monkeypatch.setattr(sys, "argv", ["bench.py"])
        bench.main()
        out = capsys.readouterr().out.strip()
        assert "\n" not in out, "stdout must be exactly one line"
        assert len(out) < 1000, f"headline line too long: {len(out)}"
        line = json.loads(out)
        for k in ("metric", "value", "unit", "vs_baseline", "step_time_s",
                  "platform", "device_kind", "n_chips", "detail_file"):
            assert k in line, k
        assert line["value"] == 1178.0
        # the full detail is in the one file, and nothing else is written
        detail = json.loads((tmp_path / line["detail_file"]).read_text())
        assert detail["detail"]["pad"] == "x" * 4000
        assert detail["detail"]["provenance"]["argv"] == "bench.py"
        assert line["detail_file"] == "workspace/artifacts/bench_detail.json"
        assert not (tmp_path / "artifacts").exists()

    def test_explicit_out_file(self, tmp_path, monkeypatch, capsys):
        import sys
        fake_file = tmp_path / "bench.py"
        fake_file.write_text("")
        monkeypatch.setattr(bench, "__file__", str(fake_file))
        monkeypatch.setattr(bench, "run_compute",
                            lambda args: self._fake_result())
        # the CLI's compile-cache setup must not touch this process's config
        monkeypatch.setattr("hemx.utils.misc.enable_compile_cache",
                            lambda: None)
        out_path = tmp_path / "r.json"
        monkeypatch.setattr(sys, "argv", ["bench.py", "--out",
                                          str(out_path)])
        bench.main()
        line = json.loads(capsys.readouterr().out.strip())
        assert line["detail_file"].endswith("r.json")
        assert json.loads(out_path.read_text())["value"] == 1178.0
