"""The reference's examples on the port, each run as
``python -m repro_torch.examples.<name>`` (on the card unless
``--device cpu``): ``quickstart``, ``serve_volume``, ``pipeline_inference``
and ``train_segmentation``."""
