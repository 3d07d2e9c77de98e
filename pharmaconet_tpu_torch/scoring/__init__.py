from .graph_match import GraphMatcher, priority_fn
from .ligand import Ligand, LigandGraph

__all__ = ["GraphMatcher", "priority_fn", "Ligand", "LigandGraph"]
