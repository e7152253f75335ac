"""Several ranks under ``torchrun``: the topology and the data axis
(``mesh``), nodes and their merges (``multihost``), TTA-, window-, case-
and member-parallel evaluation (``distributed``) and fold-parallel
training (``folds``)."""
