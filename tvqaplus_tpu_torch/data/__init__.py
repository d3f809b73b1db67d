from tvqaplus_tpu_torch.data.sampling import (
    get_all_img_ids,
    get_ts_label,
    find_match,
    get_aligned_sub_indices,
    get_aligned_sub,
)
from tvqaplus_tpu_torch.data.labels import (
    iou_single_gt_box,
    build_iou_data,
    make_att_label,
    Vocabulary,
)
from tvqaplus_tpu_torch.data.batching import StaticShapeSpec, collate_static
from tvqaplus_tpu_torch.data.synthetic import SyntheticTVQADataset
