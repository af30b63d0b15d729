"""Runnable walkthroughs of the port, counterparts of the JAX package's
`examples/`: `python -m hcrag_tpu_torch.examples.<name> --help`."""
