"""Launcher of the port (`python -m dynamo_tpu_torch.run`): OpenAI HTTP or batch."""
