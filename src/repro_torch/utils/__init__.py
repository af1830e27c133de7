from repro_torch.utils.tree import (flatten_with_paths, tree_bytes,  # noqa: F401
                                    tree_leaves, tree_map,
                                    tree_map_with_path, tree_size,
                                    tree_unflatten)
