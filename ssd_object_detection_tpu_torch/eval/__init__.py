"""Evaluation: batched prediction (decode + NMS), the COCO-style mAP evaluator (numpy
copy) and the runner that feeds one into the other."""
