"""repro_torch.checkpoint: digest-checked checkpoints on disk or on a
far-memory node (twin of ``repro/checkpoint/``)."""
