"""chip_smoke.py's training phases (train_lm, train_flow, train_e2e, train_hifigan,
train_v1) and its train -> synthesize -> evaluate phase (eval)
rehearsed on the CPU: the code the card runs at full CosyVoice2 width,
with the config constants patched to tiny widths in float32 and the
learning rate raised so that tiny models' loss falls within TRAIN_STEPS
steps. The wrappers launch no kernel on CPU tensors, so the decode steps'
expected launches are patched to 0."""

import os

import pytest
import torch

import chip_smoke
from cosyvoice_tpu_torch.runtime import engine as engine_mod
from cosyvoice_tpu_torch.utils.config import build_flow_config, build_hift_config, build_lm_config

torch.set_num_threads(2)

QWEN = {"hidden_size": 32, "num_layers": 2, "num_heads": 4, "num_kv_heads": 2, "head_dim": 8,
        "intermediate_size": 64, "vocab_size": 300, "max_cache_len": 2048, "dtype": "float32"}
LLM = {"speech_token_size": 6561, "block_size": 8, "qwen": QWEN}
FLOW = {"input_size": 32, "vocab_size": 6561, "chunk_size": 5, "attention_heads": 2, "linear_units": 64,
        "num_blocks": 1, "num_up_blocks": 1,
        "estimator": {"channels": [32], "attention_head_dim": 8, "n_blocks": 1, "num_mid_blocks": 1,
                      "num_heads": 2, "static_chunk_size": 10, "causal": True},
        "cfm": {"n_timesteps": 2}}
DIT = {"input_size": 80, "vocab_size": 6561, "encoder_type": "dit_prelookahead", "estimator_type": "dit",
       "dit": {"dim": 32, "depth": 1, "heads": 2, "dim_head": 16, "ff_mult": 2}, "cfm": {"n_timesteps": 2}}
HIFT = {"base_channels": 32, "resblock_kernel_sizes": [3], "resblock_dilations": [[1]],
        "source_resblock_kernel_sizes": [7, 7, 11], "source_resblock_dilations": [[1], [1], [1]],
        "nsf_sigma": 0.0, "nsf_voiced_threshold": -1.0}


def test_training_phases_rehearse_on_cpu(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)  # train_e2e writes under build/train_e2e and removes it
    monkeypatch.setattr(chip_smoke, "TRAIN_LM", LLM)
    monkeypatch.setattr(chip_smoke, "LM_CUT", LLM)
    monkeypatch.setattr(chip_smoke, "TRAIN_FLOWS", (("U-Net flow", FLOW, FLOW), ("DiT flow", DIT, DIT)))
    flags = list(chip_smoke.TRAIN_FLAGS)
    flags[flags.index("--lr") + 1] = "1e-2"
    monkeypatch.setattr(chip_smoke, "TRAIN_FLAGS", flags)
    monkeypatch.setitem(chip_smoke.PER_STEP, "bf16", dict.fromkeys(chip_smoke.PER_STEP["bf16"], 0))
    monkeypatch.setattr(chip_smoke, "_smi", lambda: "no card")
    tiny = engine_mod.build_random_engine
    monkeypatch.setattr(engine_mod, "build_random_engine",
                        lambda **kw: tiny(lm_cfg=build_lm_config(LLM), flow_cfg=build_flow_config(FLOW),
                                          hift_cfg=build_hift_config(HIFT), **kw))
    trained = {"llm": chip_smoke.phase_train_lm("cpu"), "flow": chip_smoke.phase_train_flow("cpu")}
    launches = chip_smoke.phase_train_e2e(trained, "cpu")
    assert trained == {} and set(launches) == set(chip_smoke.PER_STEP["bf16"])
    assert not os.path.exists("build/train_e2e")


# the GAN, CosyVoice-300M and train -> synthesize -> evaluate phases' tiny
# configs: HIFT above, small discriminators, the tiny v1 LM and flow with the
# full text and speech vocabularies the synthetic rows use
GAN = {"hift": HIFT, "gan": {"mpd_channels": [4, 8, 8, 16], "mrd_resolutions": [[128, 32]], "pretrain_steps": 2}}
V1_LM = {"text_encoder_input_size": 16, "llm_input_size": 32, "llm_output_size": 32, "text_token_size": 400,
         "speech_token_size": 4096, "te_heads": 2, "te_linear_units": 32, "te_blocks": 1, "lm_heads": 2,
         "lm_linear_units": 32, "lm_blocks": 2, "max_cache_len": 1024}
V1_FLOW = {"input_size": 16, "vocab_size": 4096, "attention_heads": 2, "linear_units": 32, "num_blocks": 1,
           "estimator": {"channels": [16, 16], "attention_head_dim": 8, "n_blocks": 1, "num_mid_blocks": 1,
                         "num_heads": 2, "causal": False}, "cfm": {"n_timesteps": 2}}
CAM = ((2, 3, 1), (2, 3, 2), (2, 3, 2))  # tiny CAM++ blocks (tests/test_torch_api.py's)


def test_gan_v1_and_eval_phases_rehearse_on_cpu(monkeypatch, tmp_path):
    import json

    from cosyvoice_tpu_torch.frontend import frontend as pfrontend
    from cosyvoice_tpu_torch.models.campplus import CamPPConfig
    from cosyvoice_tpu_torch.runtime.api import CosyVoice2

    monkeypatch.chdir(tmp_path)  # the phases write under build/
    monkeypatch.setattr(chip_smoke, "GAN_CFG", GAN)
    monkeypatch.setattr(chip_smoke, "GAN_CUT", GAN)
    monkeypatch.setattr(chip_smoke, "V1_TRAIN", {"llm": V1_LM, "flow": V1_FLOW})
    monkeypatch.setattr(chip_smoke, "V1_CUT", {"llm": V1_LM, "flow": V1_FLOW})
    flags = list(chip_smoke.TRAIN_FLAGS)
    flags[flags.index("--lr") + 1] = "1e-2"
    monkeypatch.setattr(chip_smoke, "TRAIN_FLAGS", flags)
    monkeypatch.setattr(chip_smoke, "_smi", lambda: "no card")
    monkeypatch.setattr(pfrontend, "CamPPConfig", lambda: CamPPConfig(blocks=CAM))
    hift = chip_smoke.phase_train_hifigan("cpu")
    chip_smoke.phase_train_v1("cpu")
    config = {"llm": LLM, "flow": FLOW, "hift": HIFT, "frontend": {"s3": {"d_model": 64, "num_heads": 4,
                                                                          "num_layers": 2}}}
    model = tmp_path / "build" / "model"
    model.mkdir()
    (model / "config.json").write_text(json.dumps(config))
    CosyVoice2(str(model), device="cpu").save_pretrained(str(model))
    launches = chip_smoke.phase_eval(str(model), hift, "cpu")
    assert set(launches) == set(chip_smoke.PER_STEP["bf16"])


def test_grpo_and_multihost_phases_rehearse_on_cpu(monkeypatch, tmp_path):
    """chip_smoke's grpo (the reward server on 127.0.0.1, two grpo_step
    iterations, the first update against the plain float32 step, the
    rollout copy, the rollout after the update) and multihost (a gloo
    group of one rank, the DP and FSDP steps against the plain step,
    bin/train.main --multihost) phases at tiny widths."""
    monkeypatch.chdir(tmp_path)  # multihost writes under build/multihost and removes it
    monkeypatch.setattr(chip_smoke, "GRPO_LM", LLM)
    monkeypatch.setattr(chip_smoke, "GRPO_FLOW", FLOW)
    monkeypatch.setattr(chip_smoke, "GRPO_HIFT", HIFT)
    monkeypatch.setattr(chip_smoke, "MULTIHOST_LM", LLM)
    monkeypatch.setattr(chip_smoke, "MULTIHOST_MAIN", {"llm": LLM})
    monkeypatch.setattr(chip_smoke, "_smi", lambda: "no card")
    launches = chip_smoke.phase_grpo("cpu")
    assert set(launches) == set(chip_smoke.PER_STEP["bf16"])
    chip_smoke.phase_multihost("cpu")
    assert not os.path.exists("build/multihost")
