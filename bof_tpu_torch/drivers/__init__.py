# CLI drivers (reference: drivers/).  Each module has a main(); run as
# `python -m bof_tpu_torch.drivers.<name>`.
