"""Proxy-head training with the PyTorch port (the counterpart of
`train_example.py`, upstream developer/train_example.py).

Expects:
  dataset/protein/{code}.pdb        — pocket PDBs
  dataset/protein_info.csv          — "code,x,y,z" pocket centers
  dataset/train_key.txt             — pocket codes, one per line
  dataset/ligand.pkl                — {code: [(ligand_id, smiles, affinity)]}

    python examples/train_example_torch.py [--device cuda]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pharmaconet_tpu_torch.training.config import Config  # noqa: E402
from pharmaconet_tpu_torch.training.trainer import Trainer  # noqa: E402

if __name__ == "__main__":
    p = argparse.ArgumentParser("proxy-head training demo")
    p.add_argument("--device", default="cuda", help="torch device (cuda without a card raises)")
    args = p.parse_args()

    config = Config()
    config.data.protein_dir = "./dataset/protein/"
    config.data.protein_info_path = "./dataset/protein_info.csv"
    config.data.train_protein_code_path = "./dataset/train_key.txt"
    config.data.ligand_path = "./dataset/ligand.pkl"
    config.train.max_iterations = 100
    config.train.batch_size = 16
    config.train.log_every = 1
    config.train.print_every = 1
    config.train.val_every = 10
    config.log_dir = "./result/debug"

    trainer = Trainer(config, device=args.device)
    trainer.fit()  # trainer.fit(resume_from="./result/debug/save/resume.ckpt")
