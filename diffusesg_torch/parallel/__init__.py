"""Data and tensor parallelism on ``torch.distributed``, one process per card.

``distributed`` starts the process group from the rendezvous variables,
``mesh`` holds the world, the (data, model) grid and their collectives,
``shardmap_dp`` and ``sharded_step`` the two data-parallel steps (and the
tensor-parallel one), ``tp`` the tensor-parallel split of the model and its
state.
"""
