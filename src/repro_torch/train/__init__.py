"""Fault-tolerant training loop (checkpoint/restart, preemption-safe,
deterministic restart-safe data)."""

from repro_torch.train.loop import TrainLoopConfig, make_train_step, train
