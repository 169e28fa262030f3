"""The LM layer zoo of the port.

``dot`` (f32-accumulating products), ``norms``, ``rope``, ``embedding``,
``mlp``, ``attention``, ``moe`` (top-k MoE) and ``ssm`` (Mamba2-SSD).
Plain functions on tensors and nested dicts of tensors, in the
reference's parameter layout.  M-RoPE and the frontend stubs wait in
ROADMAP.md (Queue 1, item 14).
"""
