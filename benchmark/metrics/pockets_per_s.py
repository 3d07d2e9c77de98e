"""pockets_per_s: pockets modelled by the window's passes over the time
from the window's start to the end of its last pass (the modeling route's
runs only: model_flops.modeled_items)."""

import model_flops


def read(records):
    items = model_flops.modeled_items(records)
    return items / records["window_s"] if items else None
