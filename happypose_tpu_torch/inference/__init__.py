"""The MegaPose and CosyPose single-view pipelines, the detector wrapper and
their data types."""
