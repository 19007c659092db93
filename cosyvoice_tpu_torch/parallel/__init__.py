"""Multi-device training over torch.distributed: the ("dp", "tp") mesh and
its sharding rules (sharding.py) and the GPipe pipeline over a "pp" axis
(pipeline.py)."""
