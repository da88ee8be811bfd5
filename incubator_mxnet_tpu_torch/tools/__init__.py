"""Command-line tools of the port (JAX counterpart: the repo's ``tools/``):
``python -m incubator_mxnet_tpu_torch.tools.im2rec``."""
