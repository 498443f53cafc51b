"""The data × model mesh over ``torch.distributed`` (``mesh.py``), its
autograd-aware collectives (``collectives.py``) and the launch of local
ranks (``launch.py``)."""
