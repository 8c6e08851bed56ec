"""repro_torch.serving: the serving frontend of the port.

Twin of ``repro/serving``:

* ``engine``    — ``ServeEngine``/``Request``: slot-based continuous
  batching with KV paging, decode/paging overlap and fault shedding,
  plus the frontend's hooks (admission per step, a page range of a
  shared plane, a wall-clock drain deadline);
* ``workload``  — seeded open-loop traffic: burst, Poisson, bursty
  (Markov-modulated) and diurnal arrivals, and per-tenant request mixes
  drawn over the ``configs`` zoo's prompt and decode shapes;
* ``admission`` — continuous batching on a virtual-time clock:
  KV-capacity-aware refill, tenant token quotas, priority classes and
  SLO shedding (``Request.failed`` starting ``slo``);
* ``fleet``     — ``FleetRouter``: N replicas over one shared memory
  plane, least-outstanding-work routing with tenant affinity, and
  re-routing when a replica dies.

``launch/serve.py`` is the CLI over all of it.
"""
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.engine import (Request, ServeEngine, failure_kind,
                                        summarize_requests)
from repro_torch.serving.fleet import FleetRouter
from repro_torch.serving.workload import (ArrivalEvent, ArrivalProcess,
                                          BurstArrivals, BurstyArrivals,
                                          DiurnalArrivals, PoissonArrivals,
                                          RequestMix, TenantSpec, Workload,
                                          default_tenants, mix_for_arch,
                                          parse_arrivals)

__all__ = [
    "ServeEngine", "Request", "failure_kind", "summarize_requests",
    "AdmissionController", "FleetRouter",
    "ArrivalProcess", "BurstArrivals", "PoissonArrivals",
    "BurstyArrivals", "DiurnalArrivals", "parse_arrivals",
    "RequestMix", "TenantSpec", "Workload", "ArrivalEvent",
    "default_tenants", "mix_for_arch",
]
