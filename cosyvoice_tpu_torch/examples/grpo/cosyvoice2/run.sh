#!/bin/bash
# GRPO RL recipe for the CosyVoice2 speech-token LM on the PyTorch port:
# prompt jsonl -> token2wav+ASR reward server -> the GRPO loop.
# Run from this directory; the model dir holds the port's checkpoints
# (lm.msgpack, flow.msgpack, hift.msgpack: tools/convert_checkpoint.py).
set -e
export PYTHONPATH=../../../..:$PYTHONPATH

stage=0
stop_stage=2

pretrained_model_dir=${PRETRAINED:-../../../../pretrained_models/CosyVoice2-0.5B}
reward_port=${REWARD_PORT:-8000}
device=${DEVICE:-cuda}
# ASR hook for the reward server: module:function -> fn(wav, sr) -> str
asr=${ASR:?set ASR=module:function for the reward transcriber}

if [ ${stage} -le 0 ] && [ ${stop_stage} -ge 0 ]; then
  echo "Stage 0: prompts jsonl from kaldi text files"
  python -m cosyvoice_tpu_torch.examples.grpo.cosyvoice2.prepare_data \
    --text ${TEXT:-../../../../examples/libritts/cosyvoice2/data/train-clean-100/text} --out prompts.jsonl
fi

if [ ${stage} -le 1 ] && [ ${stop_stage} -ge 1 ]; then
  echo "Stage 1: start the token2wav+ASR reward server (background)"
  python -m cosyvoice_tpu_torch.serving.reward_server \
    --model_dir $pretrained_model_dir --asr $asr --port $reward_port --device $device &
  echo $! > reward_server.pid
  sleep 30
fi

if [ ${stage} -le 2 ] && [ ${stop_stage} -ge 2 ]; then
  echo "Stage 2: GRPO loop (K rollouts per prompt, group-normalised advantages, PPO clip + KL to the reference)"
  python -m cosyvoice_tpu_torch.bin.rl_grpo \
    --train_data prompts.jsonl \
    --checkpoint $pretrained_model_dir/lm.msgpack \
    --tokenizer_path $pretrained_model_dir \
    --reward_url http://127.0.0.1:${reward_port}/v2/models/reward/infer \
    --model_dir `pwd`/exp/grpo --device $device
  kill $(cat reward_server.pid) 2>/dev/null || true
fi
