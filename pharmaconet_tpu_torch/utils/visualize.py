"""PyMOL visualization of pharmacophore models.

Rebuilds upstream PharmacoNet utils/visualize.py:52-192: pseudoatoms for each
hotspot and pharmacophore point, dashed interaction lines, grouped per NCI
type. Works in two modes:

  * pymol importable — writes a .pse session directly (reference behavior)
  * pymol absent     — writes a .pml command script with the same content,
                       loadable by any PyMOL later (this environment has no
                       pymol wheel; the script path keeps the feature usable)
"""

from __future__ import annotations

from pathlib import Path

PHARMACOPHORE_COLOR = {
    "Hydrophobic": "orange",
    "Aromatic": "deeppurple",
    "Cation": "blue",
    "Anion": "red",
    "HBond_acceptor": "magenta",
    "HBond_donor": "cyan",
    "Halogen": "yellow",
}

INTERACTION_COLOR = {
    "Hydrophobic": "orange",
    "PiStacking_P": "deeppurple",
    "PiStacking_T": "deeppurple",
    "PiCation_lring": "blue",
    "PiCation_pring": "deeppurple",
    "HBond_ldon": "magenta",
    "HBond_pdon": "cyan",
    "SaltBridge_lneg": "blue",
    "SaltBridge_pneg": "red",
    "XBond": "yellow",
}


def _have_pymol() -> bool:
    try:
        import pymol  # noqa: F401

        return True
    except ImportError:
        return False


def _model_commands(model, prefix: str) -> list[str]:
    """PyMOL commands drawing one pharmacophore model."""
    lines: list[str] = []
    nci_groups: dict[str, list[str]] = {}
    for node in model.nodes:
        hotspot_color = INTERACTION_COLOR[node.interaction_type]
        point_color = PHARMACOPHORE_COLOR[node.type]
        hx, hy, hz = node.hotspot_position
        px, py, pz = node.center
        hotspot_id = f"{prefix}hotspot{node.index}"
        point_id = f"{prefix}point{node.index}"
        interaction_id = f"{prefix}interaction{node.index}"
        nci_id = f"{prefix}NCI{node.index}"
        lines += [
            f"pseudoatom {hotspot_id}, pos=[{hx:.3f},{hy:.3f},{hz:.3f}], color={hotspot_color}",
            f'cmd.set("sphere_color", "{hotspot_color}", "{hotspot_id}")',
            f"pseudoatom {point_id}, pos=[{px:.3f},{py:.3f},{pz:.3f}], color={hotspot_color}",
            f'cmd.set("sphere_color", "{point_color}", "{point_id}")',
            f'cmd.set("sphere_scale", {node.radius:.4f}, "{point_id}")',
            f"distance {interaction_id}, {hotspot_id}, {point_id}",
            f'cmd.set("dash_color", "{point_color}", "{interaction_id}")',
            f"group {nci_id}, {hotspot_id} {point_id} {interaction_id}",
        ]
        nci_groups.setdefault(node.interaction_type, []).append(nci_id)
    for interaction_type, group in nci_groups.items():
        lines.append(f"group {prefix}{interaction_type}, {' '.join(group)}")
        lines.append(f"group {prefix}Model, {prefix}{interaction_type}")
    return lines


def _style_commands(protein_name: str) -> list[str]:
    return [
        f'cmd.set("stick_transparency", 0.6, "{protein_name}")',
        f'cmd.set("cartoon_transparency", 0.6, "{protein_name}")',
        f'color gray90, {protein_name} and (name C*)',
        'cmd.set("sphere_scale", 0.3, "*hotspot*")',
        'cmd.set("sphere_transparency", 0.2, "*point*")',
        'cmd.set("dash_gap", 0.2, "*interaction*")',
        'cmd.set("dash_length", 0.4, "*interaction*")',
        'hide label, *interaction*',
        "bg_color white",
        f"show sticks, {protein_name}",
        "show sphere, *Model",
        "show dash, *Model",
    ]


def build_single_script(
    model,
    protein_path: str | None,
    ligand_path: str | None,
    prefix: str,
) -> list[str]:
    prefix = f"{prefix}_" if prefix else ""
    lines: list[str] = []
    if protein_path:
        lines.append(f"load {protein_path}, {prefix}Protein")
    lines.append("remove hetatm")
    if ligand_path:
        lines.append(f"load {ligand_path}, {prefix}Ligand")
    lines += _model_commands(model, prefix)
    lines += _style_commands(f"{prefix}Protein")
    return lines


def build_multiple_script(
    model_dict: dict[str, tuple],
    protein_path: str,
    pdb: str,
) -> list[str]:
    lines = [f"load {protein_path}, {pdb}", "remove hetatm"]
    for prefix, (model, ligand_path) in model_dict.items():
        if ligand_path:
            lines.append(f"load {ligand_path}, {prefix}_Ligand")
        lines += _model_commands(model, f"{prefix}_")
        lines.append(f"group {prefix}, {prefix}_Model {prefix}_Ligand")
    lines += _style_commands(pdb)
    return lines


def _write(lines: list[str], save_path: str) -> str:
    """Run in pymol (-> .pse) when available, else write a .pml script."""
    if _have_pymol() and save_path.endswith(".pse"):
        import pymol
        from pymol import cmd

        pymol.finish_launching(["pymol", "-pcq", "-K"])
        cmd.reinitialize()
        cmd.feedback("disable", "all", "everything")
        for line in lines:
            if line.startswith("cmd.set"):
                eval(line, {"cmd": cmd})  # noqa: S307 - our own generated commands
            else:
                cmd.do(line)
        cmd.save(save_path)
        return save_path
    script_path = str(Path(save_path).with_suffix(".pml"))
    with open(script_path, "w") as w:
        w.write("\n".join(lines) + "\n")
    return script_path


def visualize_single(
    model,
    protein_path: str | None,
    ligand_path: str | None,
    prefix: str,
    save_path: str,
) -> str:
    """Returns the written path (.pse with pymol, .pml otherwise)."""
    if protein_path is None:
        # fall back to the pdbblock stored in the model
        block_path = str(Path(save_path).with_suffix(".protein.pdb"))
        with open(block_path, "w") as w:
            w.write(model.pdbblock)
        protein_path = block_path
    return _write(build_single_script(model, protein_path, ligand_path, prefix), save_path)


def visualize_multiple(
    model_dict: dict[str, tuple],
    protein_path: str,
    pdb: str,
    save_path: str,
) -> str:
    return _write(build_multiple_script(model_dict, protein_path, pdb), save_path)


def _main() -> int:
    """Standalone visualization CLI (reference utils/visualize.py __main__)."""
    import argparse

    from ..pharmacophore.model import PharmacophoreModel

    parser = argparse.ArgumentParser(
        "visualize", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("model", type=str, help="pharmacophore model path (.pm | .json)")
    parser.add_argument("-p", "--protein", type=str, help="protein file path")
    parser.add_argument("-l", "--ligand", type=str, help="reference ligand file path")
    parser.add_argument("-o", "--out", type=str, required=True, help="output (.pse/.pml)")
    parser.add_argument("--prefix", type=str, default="", help="object prefix")
    args = parser.parse_args()
    written = visualize_single(
        PharmacophoreModel.load(args.model), args.protein, args.ligand, args.prefix, args.out
    )
    print(f"wrote {written}")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
