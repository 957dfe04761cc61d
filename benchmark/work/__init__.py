"""Frozen counts of the work the timed entry needs, computed from shapes
and inputs, never from which kernel route ran; and the cards' peaks."""
