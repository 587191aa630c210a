from repro_torch.roofline.counts import count_ops, dot_flops
from repro_torch.roofline.report import (RooflineTerms, load_artifacts,
                                         markdown_table, model_flops_for,
                                         to_terms)

__all__ = ["RooflineTerms", "count_ops", "dot_flops", "load_artifacts",
           "markdown_table", "model_flops_for", "to_terms"]
