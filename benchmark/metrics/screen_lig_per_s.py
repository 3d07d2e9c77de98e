"""screen_lig_per_s: ligands scored by the window's passes over the time
from the window's start to the end of its last pass."""


def read(records):
    return records["items"] / records["window_s"]
