from repro_torch.train.faults import FaultInjected, FaultPlan
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.sentinel import (SentinelConfig, StabilitySentinel,
                                        Verdict)
from repro_torch.train.serve import (greedy_generate,
                                     greedy_generate_reference)
from repro_torch.train.step import (TrainState, check_trainable,
                                    init_train_state, make_eval_step,
                                    make_train_step, train_path_summary)

__all__ = ["FaultInjected", "FaultPlan", "LoopConfig", "SentinelConfig",
           "StabilitySentinel", "Trainer", "TrainState", "Verdict",
           "check_trainable", "greedy_generate", "greedy_generate_reference",
           "init_train_state", "make_eval_step", "make_train_step",
           "train_path_summary"]
