"""Training: the train state, the step and the loop over the zoo's models,
and the fault-tolerance pieces (``ft``) that the loop and the durable
session engine take."""
from repro_torch.train.ft import PreemptionGuard, StepTelemetry
from repro_torch.train.loop import make_eval_step, make_train_step, train
from repro_torch.train.state import TrainState, init_train_state, train_state_pspec

__all__ = ["PreemptionGuard", "StepTelemetry", "TrainState", "init_train_state",
           "train_state_pspec",
           "make_train_step", "make_eval_step", "train"]
