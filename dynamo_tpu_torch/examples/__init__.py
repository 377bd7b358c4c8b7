"""Runnable deployments of the port (``python -m
dynamo_tpu_torch.examples.<name>``)."""
