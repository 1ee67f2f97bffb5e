"""Launch layer: launchers, the dry run, roofline and report (mirrors
repro/launch).

``train`` and ``serve`` are the training and serving launchers
(``python -m repro_torch.launch.train`` / ``.serve``; the card by default,
``--device cpu`` for the plain versions). ``dryrun`` walks every (arch x
shape) cell once on the meta device under the op-level cost walk
(``op_analysis``, the counterpart of the reference's ``hlo_analysis``), on
one card or over the reference's production meshes (pod1, 256 cards;
pod2, 512) in a fake process group, prices it at the H100's figures
(``roofline``) and writes one JSON a cell, which ``report`` renders; none
of them needs a card. ``mesh`` builds meshes of cards and places
parameters on them (the sharded engine's and the train step's).
"""
