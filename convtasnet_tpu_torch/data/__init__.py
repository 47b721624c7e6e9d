"""Audio input/output, manifests and separation batches."""
