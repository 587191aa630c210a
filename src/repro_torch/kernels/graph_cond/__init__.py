"""CUDA graph conditional IF nodes (``csrc/graph_cond.cu``), which
``models.graphs.StepGraph(guard=)`` captures a guarded step with."""
