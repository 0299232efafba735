"""Multi-device execution: the mesh, its process groups and tensor-parallel
sharding (mesh.py), their collectives (collectives.py), and the child
processes of ranks and serving workers (launch.py)."""
