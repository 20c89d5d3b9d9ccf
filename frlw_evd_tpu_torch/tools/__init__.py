"""Command-line tools of the port (counterpart of the repository's tools/):
the offline TAF, Event Volume, Event Count Image and Surface of Active
Events generators and the streaming inference tool, each run as
`python -m frlw_evd_tpu_torch.tools.<name>`."""
