"""Command-line tools of the port (counterpart of the repository's tools/):
the offline TAF generator and the streaming inference tool, each run as
`python -m frlw_evd_tpu_torch.tools.<name>`."""
