"""SubNetAct core: the control space Phi, the three operators, Pareto NAS
+ predictors (copies of the jax-free ``repro.core`` modules plus the torch
operators), and the conv supernet's SubnetNorm calibration."""
