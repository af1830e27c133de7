from repro_torch.utils.tree import tree_bytes, tree_leaves  # noqa: F401
