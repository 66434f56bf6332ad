from .convert import (  # noqa: F401
    FlaxMapper,
    load_reference_state_dict,
    state_dict_from_flax,
)
