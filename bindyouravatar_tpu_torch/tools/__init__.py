"""Command-line tools of the port: the SAM2 mask tool and the `.cfg` batch
driver (`python -m bindyouravatar_tpu_torch.tools.<name>`)."""
