"""Batch launcher of the port (`python -m dynamo_tpu_torch.run`)."""
