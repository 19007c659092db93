"""GRPO recipes over the port's entry points."""
