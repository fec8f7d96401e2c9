"""Training substrate of the port: AdamW, sandwich-rule supernet training,
synthetic data, atomic checkpoints with crash and resume (port of
``repro.training``; the ZeRO state shardings, the cross-mesh restore and
the int8-compressed all-reduce come with distribution)."""
