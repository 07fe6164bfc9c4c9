"""Shared data model (ref nomad/structs/): the object twin of the solver's
dense tensor form. Everything above (state store, schedulers, server, client)
speaks these types."""
from .resources import (  # noqa: F401
    ComparableResources, DNSConfig, NetworkResource, NodeCpuResources,
    NodeDevice, NodeDeviceResource, NodeDiskResources, NodeMemoryResources,
    NodeNetworkResource, NodeReservedResources, NodeResources, Port,
    RequestedDevice, Resources, RESOURCE_DIMS, R_CPU, R_MEM, R_DISK,
    NUM_RESOURCE_DIMS, comparable_to_vector,
)
from .node import (  # noqa: F401
    DrainStrategy, DriverInfo, HostVolumeInfo, Node, NodeEvent,
    NODE_STATUS_DOWN, NODE_STATUS_INIT, NODE_STATUS_READY,
    NODE_STATUS_DISCONNECTED, NODE_SCHED_ELIGIBLE, NODE_SCHED_INELIGIBLE,
)
from .job import (  # noqa: F401
    Affinity, Constraint, DispatchPayloadConfig, EphemeralDisk, Job, LogConfig,
    MigrateStrategy, Multiregion, ParameterizedJobConfig, PeriodicConfig,
    ReschedulePolicy, RestartPolicy, ScalingPolicy, Service, Spread,
    SpreadTarget, Task, TaskArtifact, TaskGroup, TaskLifecycle, Template,
    UpdateStrategy, Vault, VolumeMount, VolumeRequest,
    JOB_TYPE_SERVICE, JOB_TYPE_BATCH, JOB_TYPE_SYSTEM, JOB_TYPE_SYSBATCH,
    JOB_TYPE_CORE, JOB_STATUS_PENDING, JOB_STATUS_RUNNING, JOB_STATUS_DEAD,
    JOB_DEFAULT_PRIORITY, JOB_MIN_PRIORITY, JOB_MAX_PRIORITY, CORE_JOB_PRIORITY,
    DEFAULT_NAMESPACE, OP_EQ, OP_NEQ, OP_GT, OP_GTE, OP_LT, OP_LTE, OP_REGEX,
    OP_VERSION, OP_SEMVER, OP_SET_CONTAINS, OP_SET_CONTAINS_ALL,
    OP_SET_CONTAINS_ANY, OP_DISTINCT_HOSTS, OP_DISTINCT_PROPERTY, OP_IS_SET,
    OP_IS_NOT_SET, alloc_name, alloc_name_index,
)
from .alloc import (  # noqa: F401
    AllocDeploymentStatus, AllocMetric, AllocatedDeviceResource,
    AllocatedResources, AllocatedSharedResources, AllocatedTaskResources,
    Allocation, DesiredTransition, NetworkStatus, RescheduleEvent,
    RescheduleTracker, TaskEvent, TaskState,
    ALLOC_DESIRED_RUN, ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT,
    ALLOC_CLIENT_PENDING, ALLOC_CLIENT_RUNNING, ALLOC_CLIENT_COMPLETE,
    ALLOC_CLIENT_FAILED, ALLOC_CLIENT_LOST, ALLOC_CLIENT_UNKNOWN,
    TASK_STATE_PENDING, TASK_STATE_RUNNING, TASK_STATE_DEAD,
    DESC_RESCHEDULED, DESC_NOT_NEEDED, DESC_MIGRATING, DESC_CANARY,
    DESC_NODE_TAINTED, DESC_PREEMPTED, filter_terminal_allocs,
)
from .eval import (  # noqa: F401
    Evaluation, new_id, new_ids,
    EVAL_STATUS_BLOCKED, EVAL_STATUS_PENDING, EVAL_STATUS_COMPLETE,
    EVAL_STATUS_FAILED, EVAL_STATUS_CANCELLED,
    TRIGGER_JOB_REGISTER, TRIGGER_JOB_DEREGISTER, TRIGGER_PERIODIC_JOB,
    TRIGGER_NODE_DRAIN, TRIGGER_NODE_UPDATE, TRIGGER_ALLOC_STOP,
    TRIGGER_SCHEDULED, TRIGGER_ROLLING_UPDATE, TRIGGER_DEPLOYMENT_WATCHER,
    TRIGGER_FAILED_FOLLOW_UP, TRIGGER_MAX_PLANS, TRIGGER_RETRY_FAILED_ALLOC,
    TRIGGER_QUEUED_ALLOCS, TRIGGER_PREEMPTION, TRIGGER_SCALING,
    TRIGGER_MAX_DISCONNECT, TRIGGER_RECONNECT,
    CORE_JOB_EVAL_GC, CORE_JOB_NODE_GC, CORE_JOB_JOB_GC,
    CORE_JOB_DEPLOYMENT_GC, CORE_JOB_CSI_VOLUME_CLAIM_GC,
    CORE_JOB_FAILED_EVAL_REAP, CORE_JOB_FORCE_GC,
)
from .plan import (  # noqa: F401
    Deployment, DeploymentState, DeploymentStatusUpdate, DesiredUpdates, Plan,
    PlanAnnotations, PlanResult, new_deployment,
    DEPLOYMENT_STATUS_RUNNING, DEPLOYMENT_STATUS_PAUSED,
    DEPLOYMENT_STATUS_FAILED, DEPLOYMENT_STATUS_SUCCESSFUL,
    DEPLOYMENT_STATUS_CANCELLED, DEPLOYMENT_STATUS_PENDING,
    DEPLOYMENT_STATUS_BLOCKED, DEPLOYMENT_STATUS_UNBLOCKING,
    DEPLOYMENT_TERMINAL, DESC_DEPLOYMENT_PROMOTED, DESC_NEW_DEPLOYMENT,
)
from .network import (  # noqa: F401
    Bitmap, NetworkIndex, parse_port_spec, MAX_VALID_PORT,
    DEFAULT_MIN_DYNAMIC_PORT, DEFAULT_MAX_DYNAMIC_PORT,
)
from .respool import (  # noqa: F401
    ResourceSkeleton, skeleton_for,
)
from .funcs import (  # noqa: F401
    DeviceAccounter, allocs_fit, score_fit_binpack, score_fit_spread,
    score_normalize, BINPACK_MAX_FIT_SCORE,
)
from .operator import (  # noqa: F401
    PreemptionConfig, SchedulerConfiguration,
    SCHED_ALG_BINPACK, SCHED_ALG_CONVEX, SCHED_ALG_SPREAD, SCHED_ALG_TPU,
    VALID_SCHEDULER_ALGORITHMS,
)
from .csi import (  # noqa: F401
    CSIPlugin, CSIVolume, CSIVolumeClaim, plugin_stub, volume_stub,
    ACCESS_MODE_MULTI_NODE_MULTI_WRITER, ACCESS_MODE_MULTI_NODE_READER,
    ACCESS_MODE_MULTI_NODE_SINGLE_WRITER, ACCESS_MODE_SINGLE_NODE_READER,
    ACCESS_MODE_SINGLE_NODE_WRITER, ATTACHMENT_MODE_BLOCK,
    ATTACHMENT_MODE_FS, CLAIM_READ, CLAIM_STATE_READY_TO_FREE,
    CLAIM_STATE_TAKEN, CLAIM_WRITE,
)
from .scaling import (  # noqa: F401
    ScalingEvent, ScalingPolicyState, policy_from_group,
    JOB_TRACKED_SCALING_EVENTS, SCALING_POLICY_TYPE_HORIZONTAL,
    SCALING_TARGET_GROUP, SCALING_TARGET_JOB, SCALING_TARGET_NAMESPACE,
)
from .acl_structs import (  # noqa: F401
    ACLPolicy, ACLToken, TOKEN_TYPE_CLIENT, TOKEN_TYPE_MANAGEMENT,
    anonymous_token,
)
