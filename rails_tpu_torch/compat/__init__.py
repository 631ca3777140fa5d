"""Configs and weights from elsewhere: the original torch repo's checkpoints
(`torch_import`, `torch_export`), the JAX package's weights (`from_jax`) and
the reference's gin bindings (`gin_import`)."""

from rails_tpu_torch.compat.torch_import import (  # noqa: F401
    import_torch_checkpoint,
    import_torch_checkpoint_full,
    optimizer_state_from_reference,
    params_from_reference_state_dict,
    state_dict_from_reference,
)
from rails_tpu_torch.compat.torch_export import (  # noqa: F401
    export_torch_checkpoint,
    reference_state_dict,
    reference_state_dict_from_params,
)
from rails_tpu_torch.compat.gin_import import (  # noqa: F401
    experiment_config_from_gin,
)
