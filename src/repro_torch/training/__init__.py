"""Training (port of ``repro/training``): LR schedules, optimizers over
nested dicts of tensors, and the train-step factory."""
