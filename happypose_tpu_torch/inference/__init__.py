"""The MegaPose single-view pipeline and its data types."""
