"""Host data layer: NIfTI IO, discovery, eval preprocessing, loaders (numpy)."""
