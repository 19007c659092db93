"""Declarative JSON configs -> the port's config dataclasses.

Counterpart of cosyvoice_tpu/utils/config.py: a model dir's config.json has
sections {"llm": {...}, "flow": {...}, "hift": {...}, "frontend": {"s3":
{...}}} whose keys are dataclass fields; nested dataclasses (qwen,
estimator, dit, cfm) nest as dicts, dtypes are strings ("bfloat16"), lists
become tuples. An unknown key raises. `build_model_configs` builds the
three configs of the generation that "version" names (1: CosyVoice-300M's
LMv1Config and FlowV1Config; 2 and 3: LMConfig and FlowConfig; the HiFT's
HiFTConfig for all).
"""

import dataclasses
import json
from typing import Any, Dict, Optional

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "fp32": torch.float32,
    "float16": torch.float16,
    "fp16": torch.float16,
    None: None,
    "": None,
}


def _coerce(field: dataclasses.Field, value: Any) -> Any:
    if field.name == "dtype" and (isinstance(value, str) or value is None):
        return _DTYPES[value]
    if isinstance(value, list):
        return tuple(tuple(v) if isinstance(v, list) else v for v in value)
    return value


def build_dataclass(cls, d: Optional[Dict[str, Any]], **nested):
    """Build dataclass `cls` from dict `d`; `nested` maps a field name to the
    dataclass type used to build it recursively from a sub-dict."""
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in dict(d or {}).items():
        if key not in fields:
            raise ValueError(f"unknown {cls.__name__} field: {key!r} (have {sorted(fields)})")
        if key in nested and isinstance(value, dict):
            kwargs[key] = build_dataclass(nested[key], value)
        else:
            kwargs[key] = _coerce(fields[key], value)
    return cls(**kwargs)


def build_lm_config(d: Optional[Dict[str, Any]] = None):
    from cosyvoice_tpu_torch.models.llm import LMConfig
    from cosyvoice_tpu_torch.models.qwen2 import Qwen2Config

    return build_dataclass(LMConfig, d, qwen=Qwen2Config)


def build_flow_config(d: Optional[Dict[str, Any]] = None):
    """The flow's config; a "dit" sub-dict builds the DiT estimator's
    (CosyVoice3: with encoder_type "dit_prelookahead", estimator_type
    "dit")."""
    from cosyvoice_tpu_torch.models.dit import DiTConfig
    from cosyvoice_tpu_torch.models.flow import FlowConfig
    from cosyvoice_tpu_torch.models.flow_decoder import EstimatorConfig
    from cosyvoice_tpu_torch.models.flow_matching import CFMConfig

    return build_dataclass(FlowConfig, d, estimator=EstimatorConfig, cfm=CFMConfig, dit=DiTConfig)


def build_hift_config(d: Optional[Dict[str, Any]] = None):
    """The vocoder's config ("causal": true for CosyVoice3's)."""
    from cosyvoice_tpu_torch.models.hift import HiFTConfig

    return build_dataclass(HiFTConfig, d)


def cosyvoice3_configs(quant=False, kv_quant: bool = False):
    """(lm_cfg, flow_cfg, hift_cfg) of Fun-CosyVoice3-0.5B, the JAX API's v3
    defaults: the v3 LM layout over Qwen2-0.5B (speech tokens 6561 + 200
    special rows in the speech table, a bias-less head; `quant` /
    `kv_quant` as Qwen2Config's), the DiT flow (dim 1024, depth 22, 16
    heads x 64, lookahead channels 1024, 10 CFG Euler steps) and the causal
    HiFT at 24 kHz."""
    import dataclasses

    from cosyvoice_tpu_torch.models.dit import DiTConfig
    from cosyvoice_tpu_torch.models.flow import FlowConfig
    from cosyvoice_tpu_torch.models.hift import HiFTConfig
    from cosyvoice_tpu_torch.models.llm import LMConfig

    lm = LMConfig(speech_token_size=6561, num_special_head=200, special_in_speech_table=True)
    if quant or kv_quant:
        lm = dataclasses.replace(lm, qwen=dataclasses.replace(lm.qwen, quant=quant, kv_quant=kv_quant))
    flow = FlowConfig(input_size=80, encoder_type="dit_prelookahead", estimator_type="dit", dit=DiTConfig())
    return lm, flow, HiFTConfig(causal=True)


def build_s3_config(d: Optional[Dict[str, Any]] = None):
    """config.json "frontend": {"s3": {...}} -> S3TokenizerConfig."""
    from cosyvoice_tpu_torch.models.speech_tokenizer import S3TokenizerConfig

    return build_dataclass(S3TokenizerConfig, d)


def build_lm_v1_config(d: Optional[Dict[str, Any]] = None):
    """The CosyVoice-300M LM's config (LMv1Config)."""
    from cosyvoice_tpu_torch.models.llm_v1 import LMv1Config

    return build_dataclass(LMv1Config, d)


def build_flow_v1_config(d: Optional[Dict[str, Any]] = None):
    """The CosyVoice-300M flow's config (FlowV1Config; "estimator" and "cfm"
    sub-dicts)."""
    from cosyvoice_tpu_torch.models.flow_decoder import EstimatorConfig
    from cosyvoice_tpu_torch.models.flow_matching import CFMConfig
    from cosyvoice_tpu_torch.models.flow_v1 import FlowV1Config

    return build_dataclass(FlowV1Config, d, estimator=EstimatorConfig, cfm=CFMConfig)


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def build_model_configs(cfg: Dict[str, Any]):
    """A config.json dict -> (lm_cfg, flow_cfg, hift_cfg) of the generation
    cfg["version"] names (1, 2 or 3; default 2); absent sections take the
    config classes' defaults."""
    version = int(cfg.get("version", 2))
    if version == 1:
        return build_lm_v1_config(cfg.get("llm")), build_flow_v1_config(cfg.get("flow")), build_hift_config(cfg.get("hift"))
    return build_lm_config(cfg.get("llm")), build_flow_config(cfg.get("flow")), build_hift_config(cfg.get("hift"))
