"""Stage-isolation scores of a hermetic recipe run.

Counterpart of examples/hermetic/diag.py. Runs after run.py has filled a
--work dir and scores each link of the round trip on its own:

  A. LM token fidelity: sampled (the config's RAS) and greedy (top_k 1)
     decode against the ground-truth segment-B speech tokens (frame match).
  B. token -> wav from the ground-truth tokens (LM bypassed), re-tokenized
     with the model's own S3 tokenizer: recovery and CER.
  C. the vocoder alone on the ground-truth mel (flow bypassed).
  D. the full path (LM -> flow -> HiFT), which the quality numbers score.

Prints one JSON line per utterance, then the means as the last line.

    python -m cosyvoice_tpu_torch.examples.hermetic.diag --work /tmp/hermetic [--n 6] [--device cuda]
"""

import argparse
import dataclasses
import json
import os
import pickle

import numpy as np
import torch


def _mean(rows, fn):
    return round(float(np.mean([fn(r) for r in rows])), 3) if rows else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", required=True)
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from cosyvoice_tpu_torch.examples.hermetic import template_asr
    from cosyvoice_tpu_torch.runtime.api import AutoModel
    from cosyvoice_tpu_torch.runtime.engine import lm_prompt
    from cosyvoice_tpu_torch.serving.reward_server import cer
    from cosyvoice_tpu_torch.tools.eval_quality import _scp, _to_16k
    from cosyvoice_tpu_torch.utils.audio_io import load_wav

    work = os.path.abspath(args.work)
    model_dir, data_dir = os.path.join(work, "model"), os.path.join(work, "data")
    eval_dir = os.path.join(data_dir, "eval")
    model = AutoModel(model_dir, device=args.device)
    eng, fe, sr = model.engine, model.frontend, model.sample_rate
    lm = eng.lm
    with open(os.path.join(data_dir, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(data_dir, "utt2speech_token.pkl"), "rb") as f:
        tok_all = pickle.load(f)
    utt2prompt, ref_scp = _scp(os.path.join(eval_dir, "wav.scp")), _scp(os.path.join(eval_dir, "ref.scp"))

    def retok(wav):
        return fe._extract_speech_token(_to_16k(wav, sr))

    def score(wav, t_ref, text):
        t_syn = retok(wav)
        L = min(len(t_syn), len(t_ref))
        rec = float(np.mean(t_syn[:L] == t_ref[:L])) if L else 0.0
        hyp = template_asr.transcribe(np.asarray(wav).reshape(-1), sr, data_dir)
        return {"recov": round(rec, 3), "cer": round(cer(hyp, text), 3), "hyp": hyp, "n_tok": len(t_syn)}

    def decode(cfg, ids, types, mn, mx, seed):
        saved, lm.cfg = lm.cfg, cfg
        try:
            gen = torch.Generator(device=lm.device).manual_seed(seed)
            blocks = list(lm.generate(ids, types, gen, mn, mx))
        finally:
            lm.cfg = saved
        return np.concatenate(blocks).astype(np.int32) if blocks else np.zeros(0, np.int32)

    rows = []
    for k, (utt, prompt_path) in enumerate(utt2prompt.items()):
        if k >= args.n:
            break
        m = meta[utt]
        text_b = m["text_b"]
        gt = np.asarray(tok_all[utt], np.int32)
        gt_b = gt[len(gt) // 2 :]  # per-segment extraction: the second half is segment B
        prompt_16k = load_wav(prompt_path.strip(), 16000)
        ref = load_wav(ref_scp[f"{utt}_0"].strip(), sr)
        t_ref = retok(ref)
        mi = fe.frontend_zero_shot(text_b, m["text_a"], prompt_16k)

        # A. the LM against the ground truth, sampled and greedy
        ids, types, mn, mx = lm_prompt(lm.cfg, mi["text_tokens"], mi["prompt_text_tokens"],
                                       mi["llm_prompt_speech_token"])
        ras = decode(lm.cfg, ids, types, mn, mx, 1986)
        greedy = decode(dataclasses.replace(lm.cfg, top_k=1, top_p=1e-6, tau_r=2.0), ids, types, mn, mx, 0)

        def tokmatch(t):
            L = min(len(t), len(gt_b))
            return round(float(np.mean(t[:L] == gt_b[:L])), 3) if L else 0.0

        # B. token -> wav from the ground truth; C. the vocoder on the true mel; D. the full path
        wav_b = eng.synthesize_offline(gt_b, mi["flow_prompt_speech_token"], mi["prompt_speech_feat"],
                                       mi["flow_embedding"])
        mel_ref = torch.as_tensor(fe._extract_speech_feat(ref), device=eng.device)
        with torch.inference_mode():
            wav_c = eng.hift.inference(mel_ref, torch.Generator(device=eng.device).manual_seed(3))[0]
        wav_c = wav_c.float().cpu().numpy()
        wav_d = np.concatenate([o["tts_speech"] for o in model.inference_zero_shot(
            text_b, m["text_a"], prompt_16k, stream=False)], axis=-1)
        L = min(len(gt_b), len(t_ref))
        rows.append({
            "utt": utt, "text_b": text_b, "len_gt_b": len(gt_b), "len_t_ref": len(t_ref),
            "gtB_vs_reftok": round(float(np.mean(gt_b[:L] == t_ref[:L])), 3) if L else 0.0,
            "ras_len": len(ras), "ras_match": tokmatch(ras),
            "greedy_len": len(greedy), "greedy_match": tokmatch(greedy),
            "B_gt_tok": score(wav_b, t_ref, text_b),
            "C_gt_mel": score(wav_c, t_ref, text_b),
            "D_full": score(wav_d, t_ref, text_b),
        })
        print(json.dumps(rows[-1]), flush=True)

    summary = {
        "n": len(rows),
        "gtB_vs_reftok": _mean(rows, lambda r: r["gtB_vs_reftok"]),
        "ras_match": _mean(rows, lambda r: r["ras_match"]),
        "greedy_match": _mean(rows, lambda r: r["greedy_match"]),
        **{f"{s}_{m}": _mean(rows, lambda r, s=s, k=k, m=m: r[k][m])
           for s, k in (("B", "B_gt_tok"), ("C", "C_gt_mel"), ("D", "D_full")) for m in ("recov", "cer")},
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
