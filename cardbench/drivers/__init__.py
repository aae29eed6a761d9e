"""One module a kind of traffic: ``setup``, ``window``, ``end_to_end``,
``release`` and ``check`` of a run (``cardbench/harness.Run``)."""
