from .weights import flatten_tree, state_dict_from_jax, unflatten_tree

__all__ = ["flatten_tree", "state_dict_from_jax", "unflatten_tree"]
