"""Tensor, pipeline and data parallelism over ``torch.distributed`` (port of
parallel/).

``distributed``: the process group, the port's ``Mesh`` and the counted
collectives and stage hops; ``sharding``: the split rules, each rank's
slices and the mesh over the group; ``pipeline``: the schedule that the
model's forwards run a stage's layers through (the layer stack split over
the ranks of a pp group); ``lockstep``: the rounds in which the threaded
front ends serve a sharded engine, rank 0 taking the clients and
publishing each round's commands to every rank.
"""
