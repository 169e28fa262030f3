"""The LM layer zoo of the port: the dense decoder's layers.

``dot`` (f32-accumulating products), ``norms``, ``rope``, ``embedding``,
``mlp`` and ``attention``.  Plain functions on tensors and nested dicts of
tensors, in the reference's parameter layout.  MoE, SSM, M-RoPE and the
frontend stubs wait in ROADMAP.md (Queue 1, item 14).
"""
