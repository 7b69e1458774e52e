from repro_torch.serve.batching import ContinuousBatcher, Request, TickBudgetExceeded
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import POLICIES, Scheduler
from repro_torch.serve.slots import SlotMap
from repro_torch.serve.step import make_serve_step
