from nuzero.search.mcts import SearchParams, SearchResults, make_search_fn
from nuzero.search.tree import Tree, init_tree, reroot

__all__ = [
    "SearchParams",
    "SearchResults",
    "Tree",
    "init_tree",
    "make_search_fn",
    "reroot",
]
