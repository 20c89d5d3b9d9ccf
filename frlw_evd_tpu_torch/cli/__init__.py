"""Command-line entries of the port (counterparts of the repository's
train.py and test.py), run as `python -m frlw_evd_tpu_torch.cli.train`
and `python -m frlw_evd_tpu_torch.cli.test`."""
