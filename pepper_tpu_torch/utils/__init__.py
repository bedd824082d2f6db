"""Host utilities: model download, VCF comparison, text pileups and
training-image merges."""
