"""The CosyVoice2 GRPO recipe: prompts, the reward server, the GRPO loop (run.sh)."""
