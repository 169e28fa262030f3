"""The reference's dry-run experiments on the port, each run as
``python -m repro_torch.experiments.<name>``: ``make_tables`` (tables
from the artifacts under ``experiments/dryrun_torch/``), ``hillclimb``
(a probe cell under named overrides) and ``znni_dryrun`` (one device's
x-shard of the paper's sharded inference)."""
