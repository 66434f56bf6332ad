from .checkpoint import (  # noqa: F401
    cpu_state_dict,
    latest_checkpoint,
    merge_params,
    restore_checkpoint,
    save_checkpoint,
    save_payload,
)
from .convert import (  # noqa: F401
    FlaxMapper,
    load_reference_state_dict,
    state_dict_from_flax,
)
from .optim import (  # noqa: F401
    PhaseAdamW,
    build_optimizer,
    constant_schedule,
    global_norm,
    scaled_lr,
    warmup_cosine_schedule,
)
from .state import TrainState  # noqa: F401
from .step import make_eval_step, make_train_step  # noqa: F401
