"""Launch layer: drivers (mirrors repro/launch).

The port has the training driver, run as ``python -m repro_torch.launch.train``.
Mesh construction, the multi-pod dry-run, the roofline and the serving
driver are not ported yet (ROADMAP A10).
"""
