"""The port's executable VLA control step (``vla``) and its copy of the
paper's analytical model: the hardware catalog, the workload IR and
fleet traces, the XPU roofline simulator, the scaling family and the
claims (``hardware``, ``workload``, ``xpu_sim``, ``scaling``,
``claims``)."""
