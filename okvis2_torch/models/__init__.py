"""Learned models: Fast-SCNN segmentation and the keypoint suppression
it drives (CNN suppression of sky and person landmarks)."""
