"""Dataset-side image transforms."""
