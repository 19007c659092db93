"""Token sampling: nucleus + Repetition-Aware Sampling (RAS).

Counterpart of cosyvoice_tpu/ops/sampling.py, batched over rows and driven by
an explicit torch.Generator. Categorical draws use the Gumbel-max trick, as
jax.random.categorical does, so a draw never syncs the device with the host.
The random numbers differ from JAX's: tests compare greedy streams
(top_k=1, RAS resample disabled) and distributions.
"""

import torch

NEG_INF = -1.0e30


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row of softmax(logits): [..., V] -> [...] int64."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def nucleus_sampling(logp: torch.Tensor, generator: torch.Generator, top_p: float = 0.8, top_k: int = 25):
    """Sample from the top-p/top-k head of softmax(logp); logp [..., V].

    Element i (prob-descending order) is kept iff the exclusive cumsum of
    the probabilities before it is < top_p and i < top_k, so the element
    that crosses top_p is included (the reference loop's rule)."""
    probs = torch.softmax(logp.float(), dim=-1)
    top_probs, top_idx = torch.topk(probs, min(top_k, logp.shape[-1]), dim=-1)
    excl_cum = torch.cumsum(top_probs, dim=-1) - top_probs
    keep = excl_cum < top_p
    masked = torch.where(keep, torch.log(top_probs.clamp_min(1e-30)), torch.full_like(top_probs, NEG_INF))
    pick = categorical(masked, generator)
    return torch.gather(top_idx, -1, pick[..., None])[..., 0]


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor, penalty: float) -> torch.Tensor:
    """The CTRL / TRT-LLM repetition penalty (the reference's Triton
    consumer passes repetition_penalty 1.1): for every id marked in `seen`,
    a positive logit is divided by `penalty` and a negative one multiplied.
    logits [..., V]; seen [..., V] bool (the ids in the sequence so far)."""
    return torch.where(seen, torch.where(logits > 0, logits / penalty, logits * penalty), logits)


def ras_sampling_batch(
    logp: torch.Tensor,
    recent_tokens: torch.Tensor,
    recent_len: torch.Tensor,
    generator: torch.Generator,
    top_p: float = 0.8,
    top_k: int = 25,
    win_size: int = 10,
    tau_r: float = 0.1,
) -> torch.Tensor:
    """Repetition-aware sampling for every row.

    logp [B, V] log-probs (eos already masked by the caller before min_len);
    recent_tokens [B, win] ring of the last tokens, real ones at the right
    end and -1 padding at the left; recent_len [B] valid entries. If the
    nucleus candidate occurs >= win_size*tau_r times in the window, it is
    replaced by a draw from the full distribution with it banned.
    Returns [B] int32."""
    cand = nucleus_sampling(logp, generator, top_p=top_p, top_k=top_k)
    n = recent_tokens.shape[1]
    valid = torch.arange(n, device=logp.device)[None, :] >= n - recent_len[:, None]
    rep = ((recent_tokens == cand[:, None]) & valid).sum(dim=1)
    banned = torch.arange(logp.shape[-1], device=logp.device)[None, :] == cand[:, None]
    resampled = categorical(logp.masked_fill(banned, NEG_INF), generator)
    return torch.where(rep >= win_size * tau_r, resampled, cand).to(torch.int32)


def ras_sampling(logp, recent_tokens, recent_len, generator, top_p=0.8, top_k=25, win_size=10, tau_r=0.1):
    """Single-row RAS: logp [V], recent_tokens [win], recent_len scalar -> scalar int32."""
    rl = torch.as_tensor(recent_len, device=logp.device).reshape(1)
    return ras_sampling_batch(
        logp[None], recent_tokens[None], rl, generator, top_p=top_p, top_k=top_k, win_size=win_size, tau_r=tau_r
    )[0]
