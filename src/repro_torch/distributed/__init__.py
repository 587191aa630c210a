from repro_torch.distributed.sharding import (DEFAULT_RULES, INFERENCE_RULES,
                                              SEQ_PARALLEL_RULES,
                                              SERVING_RULES, serving_rules,
                                              spec_for)

__all__ = ["DEFAULT_RULES", "INFERENCE_RULES", "SEQ_PARALLEL_RULES",
           "SERVING_RULES", "serving_rules", "spec_for"]
