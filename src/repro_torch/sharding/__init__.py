from .rules import (  # noqa: F401
    AxisRules, TRAIN_RULES, SERVE_RULES, LONG_DECODE_RULES,
    PURE_DP_TRAIN_RULES, ParamMeta, PartitionSpec, resolve_spec,
    constrain, param_pspecs, abstract_params, shard,
)
