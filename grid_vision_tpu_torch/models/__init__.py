"""The detector and orientation nets as torch modules."""
