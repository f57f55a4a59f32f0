"""Tensor and data parallelism over ``torch.distributed`` (port of parallel/).

``distributed``: the process group, the port's ``Mesh`` and the counted
collectives; ``sharding``: the split rules and each rank's slices.
Pipeline parallelism (the JAX ``pipeline.py``) is ROADMAP queue 1 item 19,
slice B.
"""
