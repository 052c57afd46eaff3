"""Data, tensor, fully-sharded and expert parallelism over
``torch.distributed`` (port of ``audax/parallel``): the mesh
(``mesh.py``), the Megatron rule tables (``sharding.py``), the collectives
the model code writes (``comm.py``), ZeRO-3 and the train-state layout
(``fsdp.py``) and the GShard expert dispatch (``ep.py``)."""
