from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS,
    all_cells,
    applicable_shapes,
    concrete_inputs,
    get_config,
    input_specs,
    smoke_shape,
)
