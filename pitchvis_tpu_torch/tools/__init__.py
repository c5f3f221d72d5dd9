"""Measurement scripts for the port, run on the card (``python3 -m pitchvis_tpu_torch.tools.<name>``)."""
