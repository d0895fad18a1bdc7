"""Loop closure (port of vins_tpu/loop): the keyframe database with BoW
place recognition and geometric verification, and the 4-DoF pose graph."""
from .keyframe_db import KeyframeDB, LoopCloser, LoopHit
from .pose_graph import PoseGraph, drift_from_solution, optimize_pose_graph
from .vocabulary import (Vocabulary, default_vocabulary, load_vocabulary,
                         save_vocabulary, score_database, train_vocabulary,
                         transform)

__all__ = ["KeyframeDB", "LoopCloser", "LoopHit", "PoseGraph",
           "optimize_pose_graph", "drift_from_solution", "Vocabulary",
           "default_vocabulary", "train_vocabulary", "transform",
           "score_database", "save_vocabulary", "load_vocabulary"]
