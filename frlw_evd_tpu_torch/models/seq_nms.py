"""Seq-NMS: tube-linking NMS across frames (a copy of
frlw_evd_tpu/models/seq_nms.py on the port's utils/native; reference:
core/Others/seqnms/).

Host-side (per-sequence, tiny work): builds a linkage graph between boxes in
adjacent frames (IoU >= 0.5, same class), finds the max-score tube by dynamic
programming, rescores its boxes (avg/max), suppresses overlaps, repeats.
IoU kernels come from the native C++ library (utils/native.py) with numpy
fallback — the reference used a Cython extension (compute_overlap.pyx).
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np

from ..utils.native import compute_overlap


def build_box_sequences(boxes, scores, labels=None, linkage_threshold=0.5):
    """Adjacency lists between adjacent frames (seq_nms.py:27-63)."""
    box_graph = []
    for f in range(len(boxes) - 1):
        boxes_f, boxes_f1 = boxes[f], boxes[f + 1]
        adjacency = []
        overlaps_all = compute_overlap(np.asarray(boxes_f, np.float64),
                                       np.asarray(boxes_f1, np.float64))
        for i in range(len(boxes_f)):
            overlaps = overlaps_all[i]
            if labels is None:
                edges = [j for j, iou in enumerate(overlaps)
                         if iou >= linkage_threshold]
            else:
                edges = [j for j, iou in enumerate(overlaps)
                         if iou >= linkage_threshold
                         and labels[f][i] == labels[f + 1][j]]
            adjacency.append(edges)
        box_graph.append(adjacency)
    return box_graph


def find_best_sequence(box_graph, scores):
    """Max-score tube via back-to-front DP (seq_nms.py:65-132)."""
    max_scores_paths = [[(score, [idx]) for idx, score in
                         enumerate(scores[-1])]]
    sequence_roots = []

    for reverse_idx, frame_edges in enumerate(box_graph[::-1]):
        max_paths_f = []
        used = np.zeros(len(max_scores_paths[-1]), int)
        frame_idx = len(box_graph) - reverse_idx - 1
        for box_idx, box_edges in enumerate(frame_edges):
            if not box_edges:
                max_paths_f.append((scores[frame_idx][box_idx], [box_idx]))
            else:
                used[box_edges] = 1
                prev = int(np.argmax([max_scores_paths[-1][b][0]
                                      for b in box_edges]))
                score_so_far, path_so_far = max_scores_paths[-1][box_edges[prev]]
                path = copy.copy(path_so_far)
                path.append(box_idx)
                max_paths_f.append(
                    (scores[frame_idx][box_idx] + score_so_far, path))
        sequence_roots.append(
            [max_scores_paths[-1][i] for i, f in enumerate(used) if f == 0])
        max_scores_paths.append(max_paths_f)

    sequence_roots.append(max_scores_paths[-1])
    sequence_roots = sequence_roots[::-1]

    best_score, best_sequence, best_frame = 0.0, [], 0
    for index, frame_sequences in enumerate(sequence_roots):
        if not frame_sequences:
            continue
        mi = int(np.argmax([s[0] for s in frame_sequences]))
        if frame_sequences[mi][0] > best_score:
            best_score = frame_sequences[mi][0]
            best_sequence = frame_sequences[mi][1][::-1]
            best_frame = index
    return best_frame, best_sequence, best_score


def rescore_sequence(sequence, scores, frame_index, max_sum,
                     score_metric="avg"):
    if score_metric == "avg":
        avg = max_sum / len(sequence)
        for i, box_ind in enumerate(sequence):
            scores[frame_index + i][box_ind] = avg
    elif score_metric == "max":
        mx = max(scores[frame_index + i][b]
                 for i, b in enumerate(sequence))
        for i, box_ind in enumerate(sequence):
            scores[frame_index + i][box_ind] = mx
    else:
        raise ValueError("Invalid score metric")


def delete_sequence(sequence, frame_index, scores, boxes, box_graph,
                    suppress_threshold=0.3):
    for i, box_idx in enumerate(sequence):
        frame_boxes = np.asarray(boxes[frame_index + i], np.float64)
        seq_box = frame_boxes[box_idx:box_idx + 1]
        overlaps = compute_overlap(seq_box, frame_boxes)[0]
        deletes = [j for j, iou in enumerate(overlaps)
                   if iou >= suppress_threshold]
        if frame_index + i < len(box_graph):
            for j in deletes:
                box_graph[frame_index + i][j] = []
        if i > 0 or frame_index > 0:
            for prior in box_graph[frame_index + i - 1]:
                for j in deletes:
                    if j in prior:
                        prior.remove(j)


def seq_nms(boxes, scores, labels=None, linkage_threshold=0.5,
            nms_threshold=0.3, score_metric="avg"):
    """Main entry (seq_nms.py:13-25): returns the keep mask over the FIRST
    frame's boxes (False = consumed by a linked tube), mutating `scores` with
    the rescored values. Used by the YOLOX head's streaming seq-NMS hook
    (yolo_head.py:283-300)."""
    scores = [np.asarray(s, np.float64).copy() for s in scores]
    box_graph = build_box_sequences(boxes, scores, labels,
                                    linkage_threshold)
    keep_ind = np.ones(len(boxes[0]), bool)
    while True:
        frame_index, best_sequence, best_score = find_best_sequence(
            box_graph, scores)
        if len(best_sequence) <= 1:
            break
        keep_ind[best_sequence[0]] = False
        rescore_sequence(best_sequence, scores, frame_index, best_score,
                         score_metric)
        delete_sequence(best_sequence, frame_index, scores, boxes, box_graph,
                        nms_threshold)
    return keep_ind


class SeqNMSState:
    """Streaming detection memory across windows (the YOLOX head's
    nms_*_memory fields, yolo_head.py:137-149, :283-300)."""

    def __init__(self):
        self.clean()

    def clean(self):
        self.dets: Optional[np.ndarray] = None     # (n, 6) cxcywh+cls+score
        self.boxes: Optional[np.ndarray] = None    # (n, 4) xyxy
        self.scores: Optional[np.ndarray] = None
        self.labels: Optional[np.ndarray] = None

    def update(self, dets: np.ndarray):
        """Store this window's surviving detections as next window's memory."""
        if len(dets) == 0:
            return
        cx, cy, w, h = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
        self.dets = dets
        self.boxes = np.stack([cx - w / 2, cy - h / 2,
                               cx + w / 2, cy + h / 2], -1)
        self.scores = np.ones(len(dets))
        self.labels = dets[:, 4].astype(int)

    def link(self, dets: np.ndarray, nms_iou=0.6):
        """Apply seq-NMS between the memory frame and the current window's
        detections, then re-NMS the union (yolo_head.py:283-295 semantics).
        Returns the merged detections."""
        if self.dets is None or len(dets) == 0 or len(self.dets) == 0:
            self.update(dets)
            return dets
        cx, cy, w, h = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
        cur_boxes = np.stack([cx - w / 2, cy - h / 2,
                              cx + w / 2, cy + h / 2], -1)
        cur_scores = np.ones(len(dets))
        cur_labels = dets[:, 4].astype(int)
        # pad a zero row so memory indices can be "deleted" like the reference
        keep = seq_nms(
            [np.concatenate([np.zeros_like(self.boxes[0:1]), self.boxes]),
             cur_boxes],
            [np.concatenate([np.zeros(1), self.scores]), cur_scores],
            [np.concatenate([np.zeros(1, int), self.labels]), cur_labels])
        memory = self.dets[keep[1:]]
        merged = np.concatenate([memory, dets], 0)
        # final class-agnostic NMS on obj score (column 5 holds score)
        order = np.argsort(-merged[:, 5], kind="stable")
        merged = merged[order]
        mb = np.stack([merged[:, 0] - merged[:, 2] / 2,
                       merged[:, 1] - merged[:, 3] / 2,
                       merged[:, 0] + merged[:, 2] / 2,
                       merged[:, 1] + merged[:, 3] / 2], -1)
        ious = compute_overlap(mb, mb)
        keep_mask = np.ones(len(merged), bool)
        for i in range(len(merged)):
            if not keep_mask[i]:
                continue
            keep_mask[(np.arange(len(merged)) > i) & (ious[i] > nms_iou)] = False
        merged = merged[keep_mask]
        self.update(merged)
        return merged
