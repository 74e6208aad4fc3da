"""Data parallelism on ``torch.distributed``, one process per card.

``distributed`` starts the process group from the rendezvous variables,
``mesh`` holds the world and its collectives, ``shardmap_dp`` and
``sharded_step`` the two data-parallel steps.
"""
