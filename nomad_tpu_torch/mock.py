"""Canonical mock fixtures for tests (ref nomad/mock/mock.go).

Every scheduler/server/client test builds on these, exactly as the reference's
test corpus builds on nomad/mock.
"""
from __future__ import annotations

import dataclasses
import itertools

from .structs import (
    Affinity, Allocation, AllocatedResources, AllocatedSharedResources,
    AllocatedTaskResources, Constraint, DriverInfo, EphemeralDisk, Evaluation,
    Job, NetworkResource, Node, NodeCpuResources, NodeDiskResources,
    NodeMemoryResources, NodeReservedResources, NodeResources, Port,
    ReschedulePolicy, Resources, RestartPolicy, Spread, SpreadTarget, Task,
    TaskGroup, TaskLifecycle, UpdateStrategy, new_id,
    JOB_TYPE_SERVICE, JOB_TYPE_BATCH, JOB_TYPE_SYSTEM, NODE_STATUS_READY,
    OP_EQ, ALLOC_DESIRED_RUN, ALLOC_CLIENT_PENDING, alloc_name,
)

_counter = itertools.count()


def node() -> Node:
    """A ready 4-core/4GB linux node (ref mock.go Node)."""
    i = next(_counter)
    n = Node(
        id=new_id(),
        name=f"node-{i}",
        datacenter="dc1",
        node_class="",
        status=NODE_STATUS_READY,
        http_addr=f"127.0.0.1:{4646 + i}",
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "nomad.version": "1.2.3",
            "driver.exec": "1",
            "driver.mock_driver": "1",
            "driver.raw_exec": "1",
        },
        node_resources=NodeResources(
            cpu=NodeCpuResources(cpu_shares=4000, total_core_count=4,
                                 reservable_cores=[0, 1, 2, 3]),
            memory=NodeMemoryResources(memory_mb=8192),
            disk=NodeDiskResources(disk_mb=100 * 1024),
            networks=[NetworkResource(device="eth0", cidr="192.168.0.100/32",
                                      ip="192.168.0.100", mbits=1000)],
        ),
        reserved_resources=NodeReservedResources(
            cpu_shares=100, memory_mb=256, disk_mb=4 * 1024,
            reserved_host_ports="22",
        ),
        drivers={
            "exec": DriverInfo(detected=True, healthy=True),
            "mock_driver": DriverInfo(detected=True, healthy=True),
            "raw_exec": DriverInfo(detected=True, healthy=True),
            "connect_proxy": DriverInfo(detected=True, healthy=True),
        },
    )
    n.compute_class()
    return n


def drained_node() -> Node:
    n = node()
    from .structs import DrainStrategy
    n.drain_strategy = DrainStrategy(deadline_sec=0)
    n.scheduling_eligibility = "ineligible"
    return n


def job() -> Job:
    """10-count single-group service job (ref mock.go Job)."""
    j = Job(
        id=f"mock-service-{new_id()[:8]}",
        name="my-job",
        type=JOB_TYPE_SERVICE,
        priority=50,
        all_at_once=False,
        datacenters=["dc1"],
        constraints=[Constraint(ltarget="${attr.kernel.name}", rtarget="linux",
                                operand=OP_EQ)],
        task_groups=[TaskGroup(
            name="web",
            count=10,
            ephemeral_disk=EphemeralDisk(size_mb=150),
            restart_policy=RestartPolicy(attempts=3, interval_sec=600,
                                         delay_sec=60, mode="delay"),
            reschedule_policy=ReschedulePolicy(
                attempts=2, interval_sec=600, delay_sec=5,
                delay_function="constant", unlimited=False),
            tasks=[Task(
                name="web",
                driver="exec",
                config={"command": "/bin/date"},
                env={"FOO": "bar"},
                resources=Resources(
                    cpu=500, memory_mb=256,
                    networks=[NetworkResource(
                        mbits=50, dynamic_ports=[Port(label="http"),
                                                 Port(label="admin")])]),
                meta={"foo": "bar"},
            )],
            meta={"elb_check_type": "http"},
        )],
        meta={"owner": "armon"},
        status="pending",
        version=0,
    )
    return j


def batch_job() -> Job:
    j = job()
    j.id = f"mock-batch-{new_id()[:8]}"
    j.type = JOB_TYPE_BATCH
    j.priority = 50
    tg = j.task_groups[0]
    tg.name = "worker"
    tg.count = 10
    tg.reschedule_policy = ReschedulePolicy(
        attempts=2, interval_sec=600, delay_sec=5,
        delay_function="constant", unlimited=False)
    tg.tasks[0].name = "worker"
    tg.tasks[0].resources.networks = []
    return j


def system_job() -> Job:
    j = job()
    j.id = f"mock-system-{new_id()[:8]}"
    j.type = JOB_TYPE_SYSTEM
    j.priority = 100
    tg = j.task_groups[0]
    tg.count = 1
    tg.reschedule_policy = None
    tg.tasks[0].resources.networks = []
    return j


def service_job_with_update() -> Job:
    j = job()
    j.update = UpdateStrategy(max_parallel=1, health_check="checks")
    for tg in j.task_groups:
        tg.update = UpdateStrategy(max_parallel=1, health_check="checks",
                                   min_healthy_time_sec=10,
                                   healthy_deadline_sec=300,
                                   progress_deadline_sec=600)
    return j


def multi_tg_job() -> Job:
    """Three heterogeneous task groups incl. a multi-task group (ref
    mock.go variants used across reconcile/generic_sched tests)."""
    j = job()
    j.id = f"mock-multitg-{new_id()[:8]}"
    web = j.task_groups[0]
    web.count = 4
    api_tg = TaskGroup(
        name="api",
        count=6,
        ephemeral_disk=EphemeralDisk(size_mb=100),
        restart_policy=RestartPolicy(attempts=3, interval_sec=600,
                                     delay_sec=60, mode="delay"),
        reschedule_policy=ReschedulePolicy(unlimited=True, delay_sec=5),
        tasks=[
            Task(name="api", driver="exec",
                 config={"command": "/bin/date"},
                 resources=Resources(cpu=200, memory_mb=128)),
            Task(name="sidecar", driver="exec",
                 config={"command": "/bin/date"},
                 resources=Resources(cpu=50, memory_mb=64)),
        ])
    cache = TaskGroup(
        name="cache",
        count=2,
        ephemeral_disk=EphemeralDisk(size_mb=50),
        restart_policy=RestartPolicy(attempts=3, interval_sec=600,
                                     delay_sec=60, mode="delay"),
        reschedule_policy=ReschedulePolicy(unlimited=True, delay_sec=5),
        tasks=[Task(name="redis", driver="exec",
                    config={"command": "/bin/date"},
                    resources=Resources(cpu=100, memory_mb=256))])
    j.task_groups = [web, api_tg, cache]
    return j


def canary_job(canaries: int = 2, auto_promote: bool = False,
               auto_revert: bool = False) -> Job:
    """Service job whose updates go through canaries (ref mock.go Job +
    canary update blocks in deploymentwatcher tests)."""
    j = job()
    j.id = f"mock-canary-{new_id()[:8]}"
    upd = UpdateStrategy(max_parallel=2, canary=canaries,
                         health_check="task_states",
                         min_healthy_time_sec=0.01,
                         healthy_deadline_sec=30,
                         progress_deadline_sec=60,
                         auto_promote=auto_promote,
                         auto_revert=auto_revert)
    j.update = upd
    for tg in j.task_groups:
        tg.update = dataclasses.replace(upd)
        tg.tasks[0].resources.networks = []
    j.task_groups[0].count = 4
    return j


def affinity_job() -> Job:
    j = job()
    j.id = f"mock-affinity-{new_id()[:8]}"
    j.affinities = [Affinity(ltarget="${node.datacenter}", rtarget="dc1",
                             operand=OP_EQ, weight=50)]
    j.task_groups[0].tasks[0].resources.networks = []
    return j


def spread_job(attribute: str = "${node.datacenter}",
               targets: list = None) -> Job:
    j = job()
    j.id = f"mock-spread-{new_id()[:8]}"
    j.task_groups[0].spreads = [Spread(
        attribute=attribute, weight=100,
        spread_target=[SpreadTarget(value=v, percent=p)
                       for v, p in (targets or [])])]
    j.task_groups[0].tasks[0].resources.networks = []
    return j


def lifecycle_job() -> Job:
    """prestart (+sidecar) / main / poststop lifecycle shape (ref
    mock.go LifecycleJob)."""
    j = batch_job()
    j.id = f"mock-lifecycle-{new_id()[:8]}"
    tg = j.task_groups[0]
    tg.count = 1
    main = tg.tasks[0]
    tg.tasks = [
        Task(name="init", driver="mock_driver",
             config={"run_for": "0.1s"},
             lifecycle=TaskLifecycle(hook="prestart", sidecar=False),
             resources=Resources(cpu=50, memory_mb=32)),
        Task(name="side", driver="mock_driver",
             config={"run_for": "60s"},
             lifecycle=TaskLifecycle(hook="prestart", sidecar=True),
             resources=Resources(cpu=50, memory_mb=32)),
        main,
        Task(name="cleanup", driver="mock_driver",
             config={"run_for": "0.1s"},
             lifecycle=TaskLifecycle(hook="poststop", sidecar=False),
             resources=Resources(cpu=50, memory_mb=32)),
    ]
    return j


def big_node() -> Node:
    n = node()
    n.name = f"big-{n.name}"
    n.node_resources.cpu.cpu_shares = 32_000
    n.node_resources.memory.memory_mb = 65_536
    n.node_class = "large"
    n.compute_class()
    return n


def eval() -> Evaluation:  # noqa: A001 - mirrors mock.Eval
    return Evaluation(
        id=new_id(),
        namespace="default",
        priority=50,
        type=JOB_TYPE_SERVICE,
        job_id=new_id(),
        status="pending",
    )


def alloc_for(j: Job, n: Node, index: int = 0) -> Allocation:
    """An alloc of job's first TG placed on node (ref mock.go Alloc)."""
    tg = j.task_groups[0]
    task = tg.tasks[0]
    tr = AllocatedTaskResources(
        cpu_shares=task.resources.cpu,
        memory_mb=task.resources.memory_mb,
        networks=[net.copy() for net in task.resources.networks],
    )
    return Allocation(
        id=new_id(),
        eval_id=new_id(),
        name=alloc_name(j.id, tg.name, index),
        node_id=n.id,
        node_name=n.name,
        job_id=j.id,
        job=j,
        task_group=tg.name,
        allocated_resources=AllocatedResources(
            tasks={task.name: tr},
            shared=AllocatedSharedResources(disk_mb=tg.ephemeral_disk.size_mb),
        ),
        desired_status=ALLOC_DESIRED_RUN,
        client_status=ALLOC_CLIENT_PENDING,
    )


def alloc() -> Allocation:
    return alloc_for(job(), node())
