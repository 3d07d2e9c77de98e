"""Work spread over several torch devices, on a device list (`mesh.py`):
the sharded screener (`screening.py`), the sharded modeler and segmenter
(`modeling.py`), and the sharded docking-proxy scorer and cache builder
(`proxy.py`)."""
