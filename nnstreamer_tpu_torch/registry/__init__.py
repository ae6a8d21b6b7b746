"""Registries: element factories, subplugins (filter backends), config."""
