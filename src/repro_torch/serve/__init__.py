from repro_torch.serve.adapters import TaskAdapterStore
from repro_torch.serve.batching import ContinuousBatcher, Request, TickBudgetExceeded
from repro_torch.serve.engine import ServeEngine, generate
from repro_torch.serve.faults import FaultError, FaultEvent, FaultPlan
from repro_torch.serve.paging import BlockAllocator, PagingSpec, RadixPrefixCache
from repro_torch.serve.scheduler import POLICIES, Scheduler
from repro_torch.serve.slots import SlotMap
from repro_torch.serve.step import make_cow_copy, make_serve_step, make_swap
