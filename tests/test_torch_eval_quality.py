"""tools/eval_quality.py against the JAX package's tool on one tiny saved
model dir (CPU, float32), and the CER scoring against the JAX reward
server's.

The model dir is tests/test_torch_api.py's CONFIG, written by the port's
`save_pretrained` after the same pins as that test: a greedy LM whose stop
logit is raised by EOS_BIAS (requests stop at min_len), and a HiFT source
without random draws. Both tools read every checkpoint from it (the JAX
frontend's CAM++ and the port's patched to tiny blocks, as
tests/test_torch_train_cli.py does). Two prompt voices, one text each,
references for token recovery and log-mel correlation, and an ASR hook
(this module's `fake_asr`) for CER."""

import json
import sys

import numpy as np
import pytest
import torch

from cosyvoice_tpu.serving.reward_server import cer as jcer
from cosyvoice_tpu.serving.reward_server import edit_distance as jedit_distance
from cosyvoice_tpu_torch.serving.reward_server import cer, edit_distance
from cosyvoice_tpu_torch.utils.audio_io import save_wav
from tests.test_torch_api import CONFIG, EOS_BIAS

torch.set_num_threads(2)

CAM = ((2, 3, 1), (2, 3, 2), (2, 3, 2))  # tiny CAM++ blocks (tests/test_torch_api.py's)
# The wavs of the two packages agree within 1e-3 (tests/test_torch_api.py's
# ATOL), so do the metrics computed from them: x-vector cosines and log-mel
# correlations within 1e-3; the S3 tokens read off the syntheses may flip
# on a near tie, one token of the shorter sequence (25 Hz) at most
METRIC_ATOL = 1e-3


def fake_asr(wav, sample_rate):
    """A deterministic stand-in for an ASR model: a transcript of the
    synthesis's length."""
    words = ["hello", "there", "my", "good", "friend"]
    return " ".join(words[: 1 + len(wav) // sample_rate % len(words)])


def test_cer_and_edit_distance_equal_jax():
    pairs = [("Hello, world!", "hello world"), ("abc", "abd"), ("", ""), ("x", ""), ("", "abc"),
             ("你好，世界", "你好世界啊"), ("The quick brown fox.", "the quack brown fax")]
    for hyp, ref in pairs:
        assert cer(hyp, ref) == jcer(hyp, ref)
        assert edit_distance(hyp, ref) == jedit_distance(hyp, ref)


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    from cosyvoice_tpu_torch.frontend import frontend as pfrontend
    from cosyvoice_tpu_torch.models.campplus import CamPPConfig
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2

    d = tmp_path_factory.mktemp("eval")
    model = d / "model"
    model.mkdir()
    (model / "config.json").write_text(json.dumps(CONFIG))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pfrontend, "CamPPConfig", lambda: CamPPConfig(blocks=CAM))
        api = CosyVoice2(str(model), device="cpu")
    with torch.no_grad():
        api.lm.module.llm_decoder.bias[api.lm.cfg.eos_token] += EOS_BIAS
        w = api.hift.m_source.l_linear.weight
        w.zero_()
        w[0, 0] = 1.5
    api.save_pretrained(str(model))
    rng = np.random.default_rng(0)
    scp, text, ref, tts = [], [], [], {}
    for i in range(2):
        t = np.arange(int(16000 * 1.5)) / 16000
        voice = (0.3 * np.sin(2 * np.pi * (140 + 40 * i) * t) + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        save_wav(str(d / f"p{i}.wav"), voice, 16000)
        scp.append(f"utt{i} {d / f'p{i}.wav'}")
        text.append(f"utt{i} A cue.")
        tts[f"utt{i}"] = ["Hello there, my friend."]
        save_wav(str(d / f"r{i}.wav"), (0.2 * rng.standard_normal(24000)).astype(np.float32), 24000)
        ref.append(f"utt{i}_0 {d / f'r{i}.wav'}")
    for name, lines in (("wav.scp", scp), ("text", text), ("ref.scp", ref)):
        (d / name).write_text("\n".join(lines) + "\n")
    (d / "tts_text.json").write_text(json.dumps(tts))
    return d


def _argv(d):
    return ["--model_dir", str(d / "model"), "--tts_text", str(d / "tts_text.json"), "--prompt_scp",
            str(d / "wav.scp"), "--prompt_text", str(d / "text"), "--ref_scp", str(d / "ref.scp"), "--asr",
            f"{__name__}:fake_asr"]


def test_port_tool_matches_the_jax_tool(eval_dir, monkeypatch, capsys):
    from cosyvoice_tpu.frontend import frontend as jfrontend
    from cosyvoice_tpu.models import campplus as jcampplus
    from cosyvoice_tpu.tools import eval_quality as jeval
    from cosyvoice_tpu_torch.frontend import frontend as pfrontend
    from cosyvoice_tpu_torch.models.campplus import CamPPConfig
    from cosyvoice_tpu_torch.tools import eval_quality

    jcam = jcampplus.CamPPEmbedding
    for mod in (jcampplus, jfrontend):  # load_frontend's template and the frontend's own module
        monkeypatch.setattr(mod, "CamPPEmbedding", lambda: jcam(jcampplus.CamPPConfig(blocks=CAM)))
    monkeypatch.setattr(pfrontend, "CamPPConfig", lambda: CamPPConfig(blocks=CAM))
    got = eval_quality.main(_argv(eval_dir) + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    monkeypatch.setattr(sys, "argv", ["eval_quality", *_argv(eval_dir)])
    jeval.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys() and got["n"] == want["n"] == 2
    assert got["cer"] == want["cer"]  # the same transcripts: the syntheses have the same lengths
    for k in ("speaker_similarity", "mel_corr"):
        assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got[k], want[k])
        assert -1.0 <= got[k] <= 1.0
    assert abs(got["token_recovery"] - want["token_recovery"]) <= 1 / 25, got
