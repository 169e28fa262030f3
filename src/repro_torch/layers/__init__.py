"""The LM layer zoo of the port.

``dot`` (f32-accumulating products), ``norms``, ``rope`` (RoPE and
M-RoPE), ``embedding`` (with the token cross-entropy and the sinusoidal
table), ``mlp``, ``attention``, ``moe`` (top-k MoE), ``ssm`` (Mamba2-SSD)
and ``stubs`` (the VLM patch frontend).  Plain functions on tensors and
nested dicts of tensors, in the reference's parameter layout.
"""
