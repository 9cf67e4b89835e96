"""Importers of reference-layout checkpoints into the port's modules."""
