"""Document-sharded search over several devices and processes: the mesh
(`mesh.py`) and the sharded index (`sharded.py`)."""
