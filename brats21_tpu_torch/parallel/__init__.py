"""Several ranks under ``torchrun``: the topology, its data and space axes
(``mesh``), nodes and their merges (``multihost``), TTA-, window-, case-
and member-parallel evaluation and the Z-sharded forward
(``distributed``), the slab context the layers consult on the space axis
(``spatial``) and fold-parallel training (``folds``)."""
