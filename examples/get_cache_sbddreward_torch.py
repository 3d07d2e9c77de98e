"""Build a custom SBDDReward proxy target-cache database with the PyTorch port.

The counterpart of `get_cache_sbddreward.py` (upstream
pmnet_appl/sbddreward/get_cache.py). The pocket is synthetic, with a
ligand at its centre as the reference (`synthetic.write_synthetic_site`),
written into `--out_dir` with the cache database.

    python examples/get_cache_sbddreward_torch.py [--device cuda]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pharmaconet_tpu_torch.proxy import SBDDReward_Proxy  # noqa: E402
from pharmaconet_tpu_torch.synthetic import write_synthetic_site  # noqa: E402

if __name__ == "__main__":
    p = argparse.ArgumentParser("SBDDReward proxy cache demo")
    p.add_argument("--out_dir", default="./result/get_cache_sbddreward_torch")
    p.add_argument("--device", default="cuda", help="torch device (cuda without a card raises)")
    args = p.parse_args()
    out_dir = Path(args.out_dir)
    protein, ligand = write_synthetic_site(out_dir / "site")

    proxy = SBDDReward_Proxy(device=args.device)  # or SBDDReward_Proxy.load("UniDock_Vina", "ZINC", None)
    proxy._init_random()  # replace with a checkpoint for real use
    pocket_info = {"synthetic_A": (protein, ligand)}
    # serial build; for many pockets fan over the devices instead:
    #   from pharmaconet_tpu_torch.parallel.proxy import ShardedCacheBuilder
    #   cache_database = ShardedCacheBuilder(proxy).get_cache_database(
    #       pocket_info, save_path=out_dir / "cache_db.pkl")
    cache_database = proxy.get_cache_database(pocket_info, save_path=out_dir / "cache_db.pkl")
    proxy.update_cache(cache_database)
    mu, std = proxy.get_statistic("synthetic_A")
    print("mu, std:", mu, std)
    print(proxy.scoring_list("synthetic_A", ["c1ccccc1", "C1CCCCC1"]))
