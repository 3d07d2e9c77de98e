"""Work spread over several torch devices: the sharded docking-proxy scorer
and cache builder (`proxy.py`) on a device list (`mesh.py`)."""
