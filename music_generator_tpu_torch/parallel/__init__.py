"""The training step (single device; multi-device training is queued)."""
