"""Learned models: Fast-SCNN segmentation and the keypoint suppression
it drives (CNN suppression of sky and person landmarks), the public
checkpoint's importer and the trainer of the synthetic weights."""
