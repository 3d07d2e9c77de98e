"""The screening cells' ligands: real chemistry from SMILES, made by the
benchmark itself.

Frozen copies of the program's host chemistry, so that a change to the
program cannot move the traffic its benchmark runs:
`pharmaconet_tpu_torch/chem/` `fragments.py` (the fragment-enumerated
SMILES space), `smiles.py`, `smallmol.py`, `periodic.py`,
`ligand_perception.py`, the numpy backend of `embed.py`, and
`scoring/ligand.py`'s pharmacophore graph. `library.py` turns a list of
SMILES into the packed form the program's `prepack --library` reads.
"""
