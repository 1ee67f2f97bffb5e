"""Launch layer: drivers, the one-card dry run, roofline and report
(mirrors repro/launch).

``train`` and ``serve`` are the training and serving drivers
(``python -m repro_torch.launch.train`` / ``.serve``; the card by default,
``--device cpu`` for the plain versions). ``dryrun`` walks every (arch x
shape) cell once on the meta device under the op-level cost walk
(``op_analysis``, the counterpart of the reference's ``hlo_analysis``),
prices it at the H100's figures (``roofline``) and writes one JSON a cell,
which ``report`` renders; none of them needs a card. ``mesh`` builds meshes
of cards and places parameters on them (the sharded engine's); the dry
run over the production meshes is ROADMAP A11.4.
"""
