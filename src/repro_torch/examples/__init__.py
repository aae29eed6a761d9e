"""The reference's examples on the port, run as ``python -m
repro_torch.examples.<name>``: ``quickstart`` (the plan, then a few
train steps), ``train_e2e`` (the train driver end to end) and
``autoshard_inspect`` (the compiler pass by pass).  The two that train
run on ``cuda`` unless given ``--device cpu``."""
