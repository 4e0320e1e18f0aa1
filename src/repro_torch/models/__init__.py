"""The LM stack of the port (the JAX package's `models/`): shared layers,
attention, RWKV6, Mamba, MoE and the architecture-parameterised `Model`.

The forward routes attention through `kernels.ops.attention` (K9) and the
RWKV6 recurrence through `kernels.ops.wkv6` (K8); decode is plain torch on
every backend, as the JAX package computes it outside any Pallas kernel.
"""
