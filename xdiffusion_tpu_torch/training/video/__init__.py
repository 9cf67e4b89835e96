"""The video trainer."""
