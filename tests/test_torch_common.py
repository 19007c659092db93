"""Rules of the PyTorch port, plus the tiny configs its parity tests share.

- no module of cosyvoice_tpu_torch (nor chip_smoke.py) imports jax, flax or
  cosyvoice_tpu, nor scipy, transformers, msgpack or regex (absent on the
  card's machine), checked by AST scan;
- the entry points run on the card unless the caller asks for the CPU, and
  raise when there is no card; so do the training and data-prep command
  lines (bin/train.py, its --multihost, bin/average_model.py,
  bin/rl_grpo.py, serving/reward_server.py, tools/extract_embedding.py,
  tools/extract_speech_token.py) and the online token extractor;
- pyarrow is imported only inside data/processor.parquet_opener and
  tools/make_parquet_list.main (the card's machine has none).
"""

import ast
import dataclasses
import typing
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosyvoice_tpu.models.flow import FlowConfig as JFlowConfig
from cosyvoice_tpu.models.flow_decoder import EstimatorConfig as JEstimatorConfig
from cosyvoice_tpu.models.flow_matching import CFMConfig as JCFMConfig
from cosyvoice_tpu.models.hift import HiFTConfig as JHiFTConfig
from cosyvoice_tpu.models.llm import LMConfig as JLMConfig
from cosyvoice_tpu.models.qwen2 import Qwen2Config as JQwen2Config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "cosyvoice_tpu", "scipy", "transformers", "msgpack", "regex")

# ---------------------------------------------------------------- tiny configs


def jax_lm_cfg(**kw):
    qwen = JQwen2Config(
        hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
        intermediate_size=64, vocab_size=100, max_cache_len=256, dtype=jnp.float32,
    )
    return JLMConfig(**{"speech_token_size": 20, "block_size": 8, "qwen": qwen, **kw})


def jax_lm_cfg_quant(quant="int4p", kv_quant=True, **kw):
    """Tiny widths the int4 layouts take: hidden 384 and the qkv/o widths are
    multiples of 128; hidden pads to 512 and intermediate 448 to 512, as the
    full width pads 896 to 1024 and 4864 to 5120."""
    qwen = JQwen2Config(
        hidden_size=384, num_layers=2, num_heads=6, num_kv_heads=2, head_dim=64,
        intermediate_size=448, vocab_size=100, max_cache_len=256, dtype=jnp.float32,
        quant=quant, kv_quant=kv_quant,
    )
    return JLMConfig(**{"speech_token_size": 20, "block_size": 8, "qwen": qwen, **kw})


def jax_flow_cfg():
    return JFlowConfig(
        input_size=32, vocab_size=50, chunk_size=5, attention_heads=2, linear_units=64,
        num_blocks=2, num_up_blocks=1,
        estimator=JEstimatorConfig(
            channels=(32,), attention_head_dim=8, n_blocks=1, num_mid_blocks=2, num_heads=2,
            static_chunk_size=10, causal=True,
        ),
        cfm=JCFMConfig(n_timesteps=3),
    )


def jax_hift_cfg(**kw):
    return JHiFTConfig(**{
        "base_channels": 32, "resblock_kernel_sizes": (3, 7), "resblock_dilations": ((1, 3), (1, 3)),
        "source_resblock_kernel_sizes": (7, 7, 11), "source_resblock_dilations": ((1,), (1,), (1,)), **kw,
    })


def jax_lm_cfg_v3(**kw):
    """The tiny LM in the v3 layout (tests/test_engine_v3.py's): 200 special
    rows in the speech table, a bias-less head."""
    return jax_lm_cfg(**{"num_special_head": 200, "special_in_speech_table": True, **kw})


def jax_lm_cfg_quant_v3(quant="int4p", kv_quant=True, **kw):
    return jax_lm_cfg_quant(quant, kv_quant, **{"num_special_head": 200, "special_in_speech_table": True, **kw})


def jax_dit_flow_cfg(depth=2, n_timesteps=2, chunk=5):
    """The tiny v3 flow (tests/test_engine_v3.py's, two DiT blocks)."""
    from cosyvoice_tpu.models.dit import DiTConfig as JDiTConfig

    return JFlowConfig(
        input_size=80, vocab_size=50, chunk_size=chunk,
        encoder_type="dit_prelookahead", estimator_type="dit", dit_lookahead_channels=32,
        dit=JDiTConfig(dim=32, depth=depth, heads=2, dim_head=8, static_chunk_size=chunk * 2, freq_embed_dim=16),
        cfm=JCFMConfig(n_timesteps=n_timesteps),
    )


def jax_hift_cfg_v3(**kw):
    """The tiny causal HiFT (tests/test_engine_v3.py's)."""
    return JHiFTConfig(**{
        "base_channels": 32, "causal": True, "resblock_kernel_sizes": (3,), "resblock_dilations": ((1,),),
        "source_resblock_kernel_sizes": (7, 7, 11), "source_resblock_dilations": ((1,), (1,), (1,)), **kw,
    })


def jax_lm_v1_cfg(**kw):
    """The tiny CosyVoice-300M LM (tests/test_v1.py's)."""
    from cosyvoice_tpu.models.llm_v1 import LMv1Config as JLMv1Config

    return JLMv1Config(**{
        "text_encoder_input_size": 16, "llm_input_size": 32, "llm_output_size": 32, "text_token_size": 100,
        "speech_token_size": 30, "te_heads": 2, "te_linear_units": 32, "te_blocks": 1, "lm_heads": 2,
        "lm_linear_units": 32, "lm_blocks": 2, "max_cache_len": 256, "block_size": 8, **kw,
    })


def jax_flow_v1_cfg(channels=(16, 16), n_timesteps=2, **kw):
    """The tiny CosyVoice-300M flow (tests/test_v1.py's): a two-level
    non-causal U-Net."""
    from cosyvoice_tpu.models.flow_v1 import FlowV1Config as JFlowV1Config

    return JFlowV1Config(**{
        "input_size": 16, "vocab_size": 30, "attention_heads": 2, "linear_units": 32, "num_blocks": 1,
        "regulator_ratios": (1,),
        "estimator": JEstimatorConfig(channels=channels, attention_head_dim=8, n_blocks=1, num_mid_blocks=1,
                                      num_heads=2, causal=False),
        "cfm": JCFMConfig(n_timesteps=n_timesteps), **kw,
    })


def jax_hift_v1_cfg(**kw):
    """The tiny 22.05 kHz HiFT (SineGen1; tests/test_v1.py's)."""
    return JHiFTConfig(**{
        "base_channels": 32, "sampling_rate": 22050, "upsample_rates": (8, 8), "upsample_kernel_sizes": (16, 16),
        "resblock_kernel_sizes": (3,), "resblock_dilations": ((1,),), "source_resblock_kernel_sizes": (7, 11),
        "source_resblock_dilations": ((1,), (1,)), **kw,
    })


def jax_causal_noise():
    """The JAX causal source's noise buffer (models/hift.py:sine_source)."""
    from cosyvoice_tpu.models.hift import _FIXED_NOISE_SAMPLES

    return torch.from_numpy(np.array(jax.random.uniform(jax.random.PRNGKey(7), (_FIXED_NOISE_SAMPLES, 9))))


def _port_field_class(port_cls, f):
    """The dataclass type of port config field `f` (a default factory's, or
    an Optional[...] annotation's)."""
    if f.default_factory is not dataclasses.MISSING:
        return type(f.default_factory())
    if f.default is not None:
        return type(f.default)
    hint = typing.get_type_hints(port_cls)[f.name]
    return next(a for a in typing.get_args(hint) if dataclasses.is_dataclass(a))


def to_port_cfg(jcfg, port_cls):
    """The port's config dataclass with the JAX config's values (fields the
    port has; nested configs converted; jnp dtypes -> torch dtypes)."""
    kw = {}
    for f in dataclasses.fields(port_cls):
        val = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(val):
            val = to_port_cfg(val, _port_field_class(port_cls, f))
        elif f.name == "dtype":
            val = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[val]
        kw[f.name] = val
    return port_cls(**kw)


def np_tree(params):
    """JAX params -> nested dicts of numpy arrays (the converter's input)."""
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------- rules


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_flax_or_jax_package():
    files = sorted((REPO / "cosyvoice_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {f.relative_to(REPO).as_posix() for f in files}
    for served in ("serving/http_server.py", "serving/http_client.py", "serving/web_page.py",
                   "tools/bench_client.py", "runtime/batch_scheduler.py", "train/losses.py", "train/schedulers.py",
                   "train/lm_data.py", "train/trainer.py", "train/executor.py", "train/online_features.py",
                   "data/dataset.py", "data/processor.py", "bin/train.py", "bin/average_model.py",
                   "tools/extract_embedding.py", "tools/extract_speech_token.py", "tools/make_parquet_list.py",
                   "ops/f0.py", "models/discriminator.py", "train/gan.py", "tools/eval_quality.py",
                   "serving/reward_server.py", "train/grpo.py", "bin/rl_grpo.py", "parallel/sharding.py",
                   "parallel/pipeline.py", "examples/grpo/cosyvoice2/prepare_data.py"):
        assert f"cosyvoice_tpu_torch/{served}" in scanned
    bad = [
        f"{f.relative_to(REPO)}: {mod}"
        for f in files
        for mod in _imports(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def _entry_points():
    from cosyvoice_tpu_torch.models.flow import CausalFlow, FlowConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig, HiFTGenerator
    from cosyvoice_tpu_torch.models.llm import LMConfig, Qwen2LM
    from cosyvoice_tpu_torch.runtime.api import AutoModel, CosyVoice2, CosyVoice3
    from cosyvoice_tpu_torch.runtime.engine import build_random_engine, build_random_engine_v3

    lm = to_port_cfg(jax_lm_cfg(), LMConfig)
    flow = to_port_cfg(jax_flow_cfg(), FlowConfig)
    hift = to_port_cfg(jax_hift_cfg(), HiFTConfig)
    cfgs = dict(lm_cfg=lm, flow_cfg=flow, hift_cfg=hift)
    cfgs3 = dict(lm_cfg=to_port_cfg(jax_lm_cfg_v3(), LMConfig), flow_cfg=to_port_cfg(jax_dit_flow_cfg(), FlowConfig),
                 hift_cfg=to_port_cfg(jax_hift_cfg_v3(), HiFTConfig))
    from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config, MaskedDiffFlow
    from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config, TransformerLM
    from cosyvoice_tpu_torch.runtime.api import CosyVoice
    from cosyvoice_tpu_torch.runtime.engine import build_random_engine_v1

    cfgs1 = dict(lm_cfg=to_port_cfg(jax_lm_v1_cfg(), LMv1Config), flow_cfg=to_port_cfg(jax_flow_v1_cfg(), FlowV1Config),
                 hift_cfg=to_port_cfg(jax_hift_v1_cfg(), HiFTConfig))
    return {
        "TransformerLM": lambda **kw: TransformerLM(cfgs1["lm_cfg"], **kw),
        "MaskedDiffFlow": lambda **kw: MaskedDiffFlow(cfgs1["flow_cfg"], **kw),
        "build_random_engine_v1": lambda **kw: build_random_engine_v1(0, **cfgs1, **kw),
        "CosyVoice": lambda **kw: CosyVoice(**cfgs1, **kw),
        "Qwen2LM": lambda **kw: Qwen2LM(lm, **kw),
        "CausalFlow": lambda **kw: CausalFlow(flow, **kw),
        "HiFTGenerator": lambda **kw: HiFTGenerator(hift, **kw),
        "build_random_engine": lambda **kw: build_random_engine(0, **cfgs, **kw),
        "CosyVoice2": lambda **kw: CosyVoice2(**cfgs, **kw),
        "AutoModel": lambda **kw: AutoModel("", **cfgs, **kw),
        "build_random_engine_v3": lambda **kw: build_random_engine_v3(0, **cfgs3, **kw),
        "CosyVoice3": lambda **kw: CosyVoice3(**cfgs3, **kw),
    }


ENTRY_POINTS = ["Qwen2LM", "CausalFlow", "HiFTGenerator", "build_random_engine", "CosyVoice2", "AutoModel",
                "build_random_engine_v3", "CosyVoice3", "TransformerLM", "MaskedDiffFlow", "build_random_engine_v1",
                "CosyVoice"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_cuda_and_raise_without_it(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_run_on_cpu_when_asked(name):
    obj = _entry_points()[name](device="cpu")
    mods = [getattr(obj, "module", None) or getattr(obj, "lm", None) or obj]
    mods[0] = getattr(mods[0], "module", mods[0])
    if hasattr(obj, "frontend"):  # the API's speech tokenizer and speaker model
        mods += [obj.frontend.speech_tokenizer, obj.frontend.campplus]
    assert all(next(m.parameters()).device.type == "cpu" for m in mods)


def test_pyarrow_is_imported_only_inside_the_two_parquet_functions():
    """The port reads parquet in data/processor.parquet_opener and writes it
    in tools/make_parquet_list.main; pyarrow is imported inside those two
    function bodies and nowhere else (chip_smoke.py included)."""
    allowed = {("cosyvoice_tpu_torch/data/processor.py", "parquet_opener"),
               ("cosyvoice_tpu_torch/tools/make_parquet_list.py", "main")}
    found = set()
    for f in sorted((REPO / "cosyvoice_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]:
        tree = ast.parse(f.read_text(), filename=str(f))
        funcs = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        owner = {id(sub): fn.name for fn in funcs for sub in ast.walk(fn)}
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(m.split(".")[0] == "pyarrow" for m in mods):
                found.add((f.relative_to(REPO).as_posix(), owner.get(id(node))))
    assert found == allowed


def _cli_entry_points(tmp_path):
    from cosyvoice_tpu_torch.bin import average_model, rl_grpo, train
    from cosyvoice_tpu_torch.serving import reward_server
    from cosyvoice_tpu_torch.tools import eval_quality, extract_embedding, extract_speech_token
    from cosyvoice_tpu_torch.train.online_features import OnlineSpeechTokenExtractor

    (tmp_path / "v1.json").write_text('{"version": 1}')

    def train_main(model, *flags):
        return lambda: train.main(["--model", model, "--train_data", str(tmp_path / "none.list"), "--model_dir",
                                   str(tmp_path), *flags])

    return {
        "bin.train": train_main("llm"),
        "bin.train hifigan": train_main("hifigan"),
        "bin.train v1 llm": train_main("llm", "--config", str(tmp_path / "v1.json")),
        "bin.train v1 flow": train_main("flow", "--config", str(tmp_path / "v1.json")),
        "tools.eval_quality": lambda: eval_quality.main(["--tts_text", str(tmp_path / "none.json"), "--prompt_scp",
                                                         str(tmp_path / "none.scp"), "--prompt_text",
                                                         str(tmp_path / "none.txt")]),
        "bin.average_model": lambda: average_model.main(["--src_dir", str(tmp_path), "--dst_model",
                                                         str(tmp_path / "avg.msgpack")]),
        "tools.extract_embedding": lambda: extract_embedding.main(["--dir", str(tmp_path)]),
        "tools.extract_speech_token": lambda: extract_speech_token.main(["--dir", str(tmp_path)]),
        "OnlineSpeechTokenExtractor": lambda: OnlineSpeechTokenExtractor(),
        "bin.train multihost": train_main("llm", "--multihost"),
        "bin.rl_grpo": lambda: rl_grpo.main(["--train_data", str(tmp_path / "none.jsonl"), "--model_dir",
                                             str(tmp_path), "--reward_path", "json:dumps"]),
        "serving.reward_server": lambda: reward_server.main(["--asr", "json:dumps"]),
    }


@pytest.mark.parametrize("name", ["bin.train", "bin.train hifigan", "bin.train v1 llm", "bin.train v1 flow",
                                  "bin.average_model", "tools.extract_embedding", "tools.extract_speech_token",
                                  "tools.eval_quality", "OnlineSpeechTokenExtractor", "bin.train multihost",
                                  "bin.rl_grpo", "serving.reward_server"])
def test_training_entry_points_default_to_cuda_and_raise_without_it(name, tmp_path, monkeypatch):
    """Each raises before it reads any input: tests/test_torch_train_cli.py
    runs them with --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _cli_entry_points(tmp_path)[name]()
