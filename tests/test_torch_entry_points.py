"""The port's remaining entry points on the CPU at tiny width: example.py's
four modes (zero-shot offline and streamed, cross-lingual, instruct2, vc),
batch_example.py (two concurrent requests through continuous batching, two
loop iterations), bin/aot_warmup.py on a tiny saved model dir and
tools/microbench_t2w.py --tiny --device cpu; each prints its JSON summary
line last.
Each defaults to the card and raises without one, as the other entry points
(tests/test_torch_common.py). No JAX: these are the port's own programs."""

import json
import math

import pytest
import torch

from cosyvoice_tpu_torch import batch_example, example
from cosyvoice_tpu_torch.bin import aot_warmup
from cosyvoice_tpu_torch.examples.hermetic import diag
from cosyvoice_tpu_torch.examples.hermetic import run as hermetic_run
from cosyvoice_tpu_torch.tools import microbench_t2w

torch.set_num_threads(1)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_example_runs_every_mode(tmp_path, capsys):
    summary = example.main(["--device", "cpu", "--out_prefix", str(tmp_path / "demo")])
    assert _last_json(capsys) == summary
    assert summary["device"] == "cpu" and summary["sample_rate"] == 24000
    assert list(summary["modes"]) == ["zero_shot", "zero_shot_stream", "cross_lingual", "instruct2", "vc"]
    for mode, m in summary["modes"].items():
        assert m["chunks"] >= 1 and m["seconds"] > 0, mode
    assert summary["modes"]["zero_shot_stream"]["chunks"] > 1
    assert (tmp_path / "demo_zero_shot_0.wav").exists()


def test_batch_example_serves_a_wave_and_the_loop(capsys):
    summary = batch_example.main(["--device", "cpu", "--iters", "2", "--concurrency", "2"])
    assert _last_json(capsys) == summary
    assert summary["requests"] == 2 and summary["iters"] == 2 and summary["audio_s"] > 0
    assert math.isfinite(summary["rtf"]) and summary["rtf"] > 0


def test_aot_warmup_on_a_saved_dir(tmp_path, capsys):
    from cosyvoice_tpu_torch.runtime.api import AutoModel

    (tmp_path / "config.json").write_text(json.dumps(hermetic_run.CONFIG))
    AutoModel(str(tmp_path), device="cpu").save_pretrained(str(tmp_path))
    summary = aot_warmup.main(["--model_dir", str(tmp_path), "--device", "cpu"])
    assert _last_json(capsys) == summary
    assert summary["device"] == "cpu" and summary["built"] is False and summary["graph_captures"] == 0
    assert summary["first_chunk_graphs"] == 0  # graphs need the card; the body ran eagerly
    assert summary["offline_s"] > 0 and summary["stream_s"] > 0


def test_microbench_t2w_tiny(capsys):
    summary = microbench_t2w.main(["--tiny", "--device", "cpu"])
    assert _last_json(capsys) == summary
    assert summary["device"] == "cpu" and len(summary["ms"]) == 5
    assert all(v > 0 for v in summary["ms"].values()) and summary["t2w_rtf"] > 0


ENTRY_POINTS = {
    "example": lambda tmp: example.main(["--out_prefix", str(tmp / "demo")]),
    "batch_example": lambda tmp: batch_example.main(["--iters", "1"]),
    "aot_warmup": lambda tmp: aot_warmup.main(["--model_dir", str(tmp)]),
    "microbench_t2w": lambda tmp: microbench_t2w.main([]),
    "hermetic run": lambda tmp: hermetic_run.main(["--work", str(tmp / "work")]),
    "hermetic diag": lambda tmp: diag.main(["--work", str(tmp / "work")]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](tmp_path)


def test_chip_smoke_phases_rehearse_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's hermetic, aot_warmup and microbench phases on the CPU
    at the sizes the card runs them (microbench --tiny --device cpu), from a
    scratch working dir (the phases write under build/ and remove it)."""
    import chip_smoke
    from cosyvoice_tpu_torch.runtime.api import AutoModel

    monkeypatch.chdir(tmp_path)
    chip_smoke.phase_hermetic("cpu")
    assert not (tmp_path / chip_smoke.HERMETIC_WORK).exists()
    chip_smoke.phase_microbench(["--tiny", "--device", "cpu"])
    model = tmp_path / "model"
    model.mkdir()
    (model / "config.json").write_text(json.dumps(hermetic_run.CONFIG))
    AutoModel(str(model), device="cpu").save_pretrained(str(model))
    assert chip_smoke.phase_aot_warmup(str(model), "cpu") == dict.fromkeys(chip_smoke._counters(), 0)
